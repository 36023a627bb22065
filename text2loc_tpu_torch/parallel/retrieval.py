"""Gallery retrieval with the gallery sharded over a Mesh (port of
text2loc_tpu/parallel/retrieval.py).

The gallery's C rows are padded to a multiple of the mesh size; rank r
holds rows [r * C/n, (r + 1) * C/n) of the padded gallery. Each rank scores
the queries against its rows only and keeps a local top-k with global ids
(shard_local_topk); the ranks' candidates (n * k per query, not C) are
gathered and merged into the global top-k (merge_shard_topk). Padded rows
score -inf and never surface. Shards hold ascending global ids and the
merge is a stable descending sort over the candidates in rank order, so
equal scores keep the lowest global id first, as lax.top_k and the dense
evaluation/retrieval.topk_retrieval do.

shard_local_topk and merge_shard_topk are pure functions of their inputs
(one process can run them on simulated shards); all_gather_candidates and
make_sharded_topk are the collective layer over them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from text2loc_tpu_torch.parallel.mesh import Mesh, all_gather


def shard_rows(num_cells: int, mesh: Mesh) -> tuple:
    """(offset, rows per shard) of this rank in the gallery padded to a
    multiple of the mesh size."""
    per = max(math.ceil(num_cells / mesh.size), 1)
    return mesh.rank * per, per


def shard_cells(num_cells: int, mesh: Mesh) -> tuple:
    """(the real gallery ids this rank holds, as numpy, rows per shard)."""
    offset, per = shard_rows(num_cells, mesh)
    return np.arange(offset, min(offset + per, num_cells)), per


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` with zero rows appended up to `rows` rows."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def pad_gallery(cell_enc, num_shards: int):
    """(gallery with its rows padded by zero rows to a multiple of
    num_shards, the real row count). numpy arrays or tensors."""
    c = cell_enc.shape[0]
    c_pad = max(math.ceil(c / num_shards), 1) * num_shards
    if c_pad == c:
        return cell_enc, c
    if isinstance(cell_enc, torch.Tensor):
        pad = torch.zeros((c_pad - c,) + tuple(cell_enc.shape[1:]), dtype=cell_enc.dtype,
                          device=cell_enc.device)
        return torch.cat([cell_enc, pad]), c
    out = np.zeros((c_pad,) + cell_enc.shape[1:], cell_enc.dtype)
    out[:c] = cell_enc
    return out, c


def shard_local_topk(cells: torch.Tensor, texts: torch.Tensor, k: int, num_cells: int,
                     offset: int):
    """Scores of the queries against one shard and its local top-k:
    cells [C_local, D] (global rows offset .. offset + C_local), texts
    [Q, D]. Rows whose global id is >= num_cells (padding) score -inf.
    Returns (scores [Q, kl], local rows [Q, kl], global ids [Q, kl]),
    kl = min(k, C_local), by descending score, equal scores lowest id
    first (a stable descending sort; torch.topk promises no order on
    ties)."""
    scores = texts.float() @ cells.float().t()
    if offset + cells.shape[0] > num_cells:
        gids = offset + torch.arange(cells.shape[0], device=scores.device)
        scores = torch.where(gids[None, :] < num_cells, scores,
                             torch.full((), float("-inf"), device=scores.device))
    kl = min(k, cells.shape[0])
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :kl], idx[:, :kl], idx[:, :kl] + offset


def merge_shard_topk(scores: torch.Tensor, payloads, k: int):
    """The global top-k of the shards' candidates: scores [Q, n * kl] (the
    shards' local top-k lists side by side, in shard order) and payloads
    [Q, n * kl, ...] carried along (ids, positions, ...). Returns (scores
    [Q, k], tuple of payloads [Q, k, ...]); a stable descending sort, so
    equal scores keep the lowest shard (and within it the lowest id)
    first."""
    vals, sel = torch.sort(scores, dim=1, descending=True, stable=True)
    sel = sel[:, :k]
    outs = []
    for a in payloads:
        idx = sel.reshape(sel.shape + (1,) * (a.ndim - 2)).expand(sel.shape + a.shape[2:])
        outs.append(torch.gather(a, 1, idx))
    return vals[:, :k], tuple(outs)


def all_gather_candidates(mesh: Mesh, *tensors) -> tuple:
    """Each [Q, kl, ...] tensor of every rank, side by side in rank order:
    [Q, n * kl, ...] (merge_shard_topk's layout)."""
    out = []
    for t in tensors:
        g = all_gather(t, mesh)                               # [n, Q, kl, ...]
        g = g.transpose(0, 1)
        out.append(g.reshape((g.shape[0], -1) + tuple(t.shape[2:])))
    return tuple(out)


def make_sharded_topk(mesh: Mesh, k: int, num_cells: int):
    """fn(this rank's gallery rows [C_pad / n, D], texts [Q, D], alike on
    every rank) -> (scores [Q, k], global ids [Q, k]), the same on every
    rank. `num_cells`: the real gallery size."""
    offset, _ = shard_rows(num_cells, mesh)

    def topk(cells, texts):
        s_loc, _, g_loc = shard_local_topk(cells, texts, k, num_cells, offset)
        s_all, g_all = all_gather_candidates(mesh, s_loc, g_loc)
        s_top, (g_top,) = merge_shard_topk(s_all, (g_all,), k)
        return s_top, g_top

    return topk


def sharded_topk_retrieval(cell_enc, text_enc, k: int, mesh: Mesh):
    """The dense evaluation/retrieval.topk_retrieval over a sharded gallery:
    every rank passes the whole gallery [C, D] and the queries [Q, D]; each
    keeps its rows, and all return the same (scores [Q, k], ids [Q, k]).
    k must not exceed C."""
    padded, c = pad_gallery(torch.as_tensor(cell_enc), mesh.size)
    offset, per = shard_rows(c, mesh)
    texts = torch.as_tensor(text_enc)
    return make_sharded_topk(mesh, k, c)(padded[offset:offset + per].to(texts.device),
                                         texts)
