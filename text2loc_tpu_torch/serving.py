"""The serve: hint triples, description strings or embedded sentences ->
world positions (port of text2loc_tpu/serving.py: Localizer with its
persisted gallery cache, the cached and the stepwise paths,
localize_embedded and localize_text).

Built once per map and weights (or loaded from `cache_path`):

* the coarse gallery: every cell through PointNet2, ObjectEncoder and the
  obj_inter stack ([C, Dc]);
* the fine cache (precompute_fine=True): every cell through PointNet2,
  ObjectEncoder and the CCT's layer-0 object self block ([C, pad, Df] +
  mask);
* the two sentence tables over the closed hint vocabulary ([V, Dc], [V, Df]).

Per request, with the fine cache: the query text (sentence-table gathers for
hint triples; the full text trunk for embedded sentences), the coarse inter
head, full-gallery top-k, the layer-0 hint self block, cct_tail over the B*K
pairs and the world coordinates. Without it (the stepwise path): the full
coarse text trunk, top-k, then each candidate cell re-encoded through the
whole CrossMatch forward with the query's hints. Batches are padded to
power-of-two buckets and sliced back (see Localizer._padder).

With a data-parallel mesh (parallel/mesh.py) the serve is SPMD: each rank
builds and holds only its C/n rows of the gallery, the fine cache and the
cells' bbox and size (parallel/retrieval.shard_cells), and every rank calls
each localize* method with the same batch. A rank runs the text towers,
takes the top-k of its own rows with their global ids and refines its own
candidates; the ranks' (score, position, id) candidates are then gathered
and merged into the global top-k, which every rank returns alike (the
JAX package's _build_serve_sharded).
"""

from __future__ import annotations

import os
import warnings
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from text2loc_tpu_torch import constants as C
from text2loc_tpu_torch.data.batch import TextSet
from text2loc_tpu_torch.evaluation.retrieval import (
    build_vocab_sentence_table,
    encode_fine_gallery,
    encode_gallery,
    object_set,
)
from text2loc_tpu_torch.parallel.mesh import Mesh, all_gather, barrier
from text2loc_tpu_torch.parallel.retrieval import (
    all_gather_candidates,
    merge_shard_topk,
    pad_rows,
    shard_cells,
    shard_local_topk,
)

def _npz_pack(name: str, t) -> dict:
    """np.savez-safe encoding of one tensor: a dtype numpy lacks (bfloat16,
    the default serving dtype) is stored as lossless float32 with a
    `<name>__dtype` sidecar that `_npz_unpack` casts back by."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return {name: t.float().numpy(),
                name + "__dtype": np.asarray(str(t.dtype).split(".")[-1])}
    return {name: t.numpy()}


def _npz_unpack(cache: dict) -> dict:
    """Inverse of `_npz_pack` over a loaded cache dict: entries with a dtype
    sidecar come back as tensors of that dtype, the others as stored."""
    out = {}
    for k, v in cache.items():
        if k.endswith("__dtype"):
            continue
        dt = cache.get(k + "__dtype")
        out[k] = torch.from_numpy(v).to(getattr(torch, str(dt))) if dt is not None else v
    return out


class LocalizationResult(NamedTuple):
    position_w: np.ndarray       # [B, 2] top-1 world position per query
    candidates_w: np.ndarray     # [B, K, 2] per-candidate world positions
    cell_indices: np.ndarray     # [B, K] retrieved gallery cells
    scores: np.ndarray           # [B, K] retrieval similarities


class Localizer:
    """Query path over a fixed cell gallery. The caches are derived from the
    models and the map at construction; build a new Localizer for new
    weights (`cache_path` makes that cheap for an unchanged map). The
    options the models were built with (convert.build_model: sa_mode,
    vmem_gather, fused_attn / fused_ffn / fused_ln) select the kernels.

    `precompute_fine=False` keeps no fine cache: each query re-encodes its
    candidate cells (the stepwise path). `chunk`: cells per fine encoder
    call. `cache_path`: an npz file that persists the gallery, the fine
    cache and the sentence tables across restarts, guarded by a digest of
    the weights, the embedder, the config and the map. `online_encoder`: an
    object with `embed_dim` and `encode(sentences) -> (emb [N, T, E],
    mask [N, T])` that serves localize_text's out-of-vocabulary sentences.
    `mesh`: a parallel.mesh.Mesh to shard the gallery over (the module
    docstring: every rank constructs the Localizer and calls it alike; the
    device is the mesh's; rank 0 writes `cache_path`). `device` defaults to
    the CUDA card; pass "cpu" for the plain versions of the kernels."""

    def __init__(self, data, coarse_model, fine_model, embedder, cfg,
                 top_k: int = 10, mesh=None, precompute_fine: bool = True,
                 chunk: int = 128, cache_path: Optional[str] = None,
                 online_encoder=None, device="cuda"):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        if online_encoder is not None and online_encoder.embed_dim != embedder.embed_dim:
            raise ValueError("online encoder embed_dim must match the frozen table's "
                             f"({online_encoder.embed_dim} != {embedder.embed_dim})")
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.mesh = mesh
        self.data = data
        self.cfg = cfg
        self.top_k = min(top_k, data.num_cells)
        self.chunk = chunk
        self.online_encoder = online_encoder
        self.coarse_model = coarse_model.to(self.device).eval()
        self.fine_model = fine_model.to(self.device).eval()
        self.embedder = embedder.to(self.device)
        # The gallery rows this process holds: all, or this rank's shard
        # (padded with zero rows, which score -inf).
        if mesh is None:
            self.cells, self.rows, self.offset = np.arange(data.num_cells), data.num_cells, 0
        else:
            self.cells, self.rows = shard_cells(data.num_cells, mesh)
            self.offset = mesh.rank * self.rows
        self.bbox = self._local(torch.as_tensor(data.cell_bbox).float())
        self.size = self._local(torch.as_tensor(data.cell_size).float())

        self._digest = self._cache_digest() if cache_path is not None else None
        cached = self._load_cache(cache_path)
        dirty = cache_path is not None and cached is None

        def dev(name):
            return torch.as_tensor(cached[name]).to(self.device)

        with torch.no_grad():
            self.gallery = (self._local(torch.as_tensor(cached["gallery"]))
                            if cached is not None
                            else self._encode(encode_gallery, self.coarse_model))
            self.fine_emb = self.fine_mask = None
            has_fine = cached is not None and "fine_emb1" in cached
            # A precompute_fine=False build keeps an existing fine cache in
            # any re-save of the file.
            self._carry_fine = ((cached["fine_emb1"], cached["fine_mask"])
                                if not precompute_fine and has_fine else None)
            if precompute_fine:
                if has_fine:
                    self.fine_emb = self._local(torch.as_tensor(cached["fine_emb1"]))
                    self.fine_mask = self._local(torch.as_tensor(cached["fine_mask"]))
                else:
                    # A gallery-only cache still spares the coarse pass:
                    # encode the fine cache alone and re-save the file.
                    self.fine_emb, self.fine_mask = self._encode(
                        encode_fine_gallery, self.fine_model, chunk=chunk)
                    dirty = cache_path is not None
            if cached is not None and "coarse_sent_table" in cached:
                self.coarse_sent_table = dev("coarse_sent_table")
                self.fine_sent_table = dev("fine_sent_table")
            else:
                self.coarse_sent_table = build_vocab_sentence_table(
                    self.embedder, self.coarse_model.encode_text_sentences)
                self.fine_sent_table = build_vocab_sentence_table(
                    self.embedder, self.fine_model.encode_hints)
                dirty = cache_path is not None
        if dirty:
            self._save_cache(cache_path)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of a whole-gallery tensor, on its device."""
        if self.mesh is None:
            return t.to(self.device)
        return pad_rows(t[torch.as_tensor(self.cells)].to(self.device), self.rows)

    def _encode(self, encode, model, **kw):
        """encode(data, model, cfg, device, cell_indices) of this process's
        cells (padded with zero rows under a mesh)."""
        if self.mesh is None:
            return encode(self.data, model, self.cfg, self.device, **kw)
        # A rank that holds padding alone encodes one cell for the shapes.
        cells = self.cells if len(self.cells) else np.zeros(1, np.int64)
        out = encode(self.data, model, self.cfg, self.device, cell_indices=cells, **kw)
        out = out if isinstance(out, tuple) else (out,)
        out = tuple(pad_rows(t[:len(self.cells)], self.rows) for t in out)
        return out if len(out) > 1 else out[0]

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole gallery's rows of a tensor held by rows (gathered from
        every rank under a mesh)."""
        if self.mesh is None:
            return t
        g = all_gather(t, self.mesh)
        return g.reshape((-1,) + tuple(t.shape[1:]))[:self.data.num_cells]

    # ------------------------------------------------------------ the cache

    def _cache_digest(self) -> str:
        """SHA-256 over everything the cached encodings are a function of:
        both towers' state dicts (parameters and BN running statistics, in
        key order: name, shape, dtype, bytes), the embedder's checksum, the
        config knobs that change what the towers see or the values' dtype,
        and the map's geometry and feature arrays."""
        import hashlib

        h = hashlib.sha256()
        for model in (self.coarse_model, self.fine_model):
            for name, t in model.state_dict().items():
                h.update(name.encode())
                h.update(str((tuple(t.shape), str(t.dtype))).encode())
                h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                         .numpy().tobytes())
        h.update(self.embedder.checksum().encode())
        m = self.cfg.model
        h.update(str((m.object_size, m.pad_size, m.pointnet.num_points,
                      m.dtype, m.mask_padded)).encode())
        d = self.data
        for a in (d.cell_bbox, d.cell_size, d.obj_xyz, d.obj_rgb,
                  d.obj_center, d.obj_color, d.obj_num_points, d.obj_class,
                  d.obj_color_idx, d.obj_mask):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def _load_cache(self, cache_path) -> Optional[dict]:
        """The validated cache, or None (absent, unreadable or incomplete:
        the caller re-encodes). A readable cache whose cell count, pad size
        or digest does not match raises: stale encodings would serve wrong
        positions."""
        if cache_path is None or not os.path.exists(cache_path):
            return None
        try:
            # A plain dict, and the file closed: a live NpzFile would hold
            # the handle across the os.replace of a cache upgrade.
            with np.load(cache_path, allow_pickle=False) as f:
                cache = _npz_unpack({k: f[k] for k in f.files})
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:  # truncated, ...
            warnings.warn(f"unreadable gallery cache {cache_path} ({e}); re-encoding")
            return None
        if not {"gallery", "num_cells", "pad_size", "digest"} <= set(cache):
            warnings.warn(f"gallery cache {cache_path} has missing fields; re-encoding")
            return None
        if (int(cache["num_cells"]) != self.data.num_cells
                or int(cache["pad_size"]) != self.cfg.model.pad_size
                or str(cache["digest"]) != self._digest):
            raise ValueError(
                f"gallery cache {cache_path} does not match this map/model (cell "
                "count, pad size, or weight/map digest differ); delete it to re-encode")
        if "fine_emb" in cache:
            # A fine cache of raw encode_objects rows (no layer-0 object self
            # block): it must not feed cct_tail, so any re-save drops it.
            warnings.warn(
                f"gallery cache {cache_path} holds a pre-factorization fine cache "
                "(key 'fine_emb'); it will be discarded and the fine encodings "
                "rebuilt under the factored layout ('fine_emb1')")
            del cache["fine_emb"]
        return cache

    def _save_cache(self, cache_path) -> None:
        """Atomic write: a temp file unique to this writer, then os.replace,
        through a file handle (np.savez on a bare path appends '.npz').
        Under a mesh the ranks' rows are gathered, rank 0 writes, and every
        rank waits for the file."""
        fine = ((self._whole(self.fine_emb), self._whole(self.fine_mask))
                if self.fine_emb is not None else self._carry_fine)
        gallery = self._whole(self.gallery)
        if self.mesh is None or self.mesh.rank == 0:
            self._write_cache(cache_path, gallery, fine)
        if self.mesh is not None:
            barrier(self.mesh)

    def _write_cache(self, cache_path, gallery, fine) -> None:
        import tempfile

        tensors = dict(gallery=gallery)
        if fine is not None:
            tensors.update(fine_emb1=fine[0], fine_mask=fine[1])
        tensors.update(coarse_sent_table=self.coarse_sent_table,
                       fine_sent_table=self.fine_sent_table)
        payload = dict(num_cells=self.data.num_cells, pad_size=self.cfg.model.pad_size,
                       digest=np.asarray(self._digest))
        for name, t in tensors.items():
            payload.update(_npz_pack(name, t))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(cache_path)),
                                   prefix=os.path.basename(cache_path) + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, cache_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------ the paths

    @staticmethod
    def _bucket(b: int) -> int:
        """Next power-of-two batch bucket."""
        n = 1
        while n < b:
            n *= 2
        return n

    def _padder(self, n_real: int):
        """Pads a [B, ...] host array to the batch's bucket by repeating its
        last row. The JAX serve pads to reuse one compiled program per
        bucket; eager PyTorch compiles nothing per shape, so here padding
        only costs the padded rows (a batch of 5 computes 8). It is kept so
        that the serve sees log2 many batch shapes, which capturing one CUDA
        graph per bucket needs (PERF.md, open questions)."""
        bucket = self._bucket(n_real)

        def pad(a):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.repeat(a[-1:], bucket - n_real, axis=0)], axis=0
            ) if len(a) < bucket else a

        return pad

    def _candidates(self, text_enc):
        """(scores, rows of this process, global ids), each [B, K'], of the
        top-k over this process's gallery rows (K' = min(K, its rows))."""
        return shard_local_topk(self.gallery, text_enc, self.top_k, self.data.num_cells,
                                self.offset)

    def _merge(self, scores, ids, cand_w):
        """(cand_w [B, K, 2], ids [B, K], scores [B, K]): the candidates as
        they are on one device, merged over the ranks under a mesh."""
        if self.mesh is None:
            return cand_w, ids, scores
        scores, ids, cand_w = all_gather_candidates(self.mesh, scores, ids, cand_w)
        scores, (ids, cand_w) = merge_shard_topk(scores, (ids, cand_w), self.top_k)
        return cand_w, ids, scores

    def _refine_cached(self, text_enc, hints, sentence_mask):
        """Top-k over the gallery and cct_tail over the B*K pairs from the
        fine cache -> (cand_w [B, K, 2] f32, idx [B, K], scores [B, K])."""
        hints1 = self.fine_model.cct_hints_pre(hints, sentence_mask)
        scores, rows, ids = self._candidates(text_enc)
        b, k = rows.shape
        rep = torch.arange(b, device=self.device).repeat_interleave(k)
        flat = rows.reshape(-1)
        pred = self.fine_model.cct_tail(
            self.fine_emb[flat], self.fine_mask[flat], hints[rep], hints1[rep],
            sentence_mask[rep],
        ).reshape(b, k, 2)
        return self._merge(scores, ids, self._world(pred, rows))

    def _world(self, pred, rows):
        return self.bbox[rows][:, :, 0:2] + pred.float() * self.size[rows][..., None]

    @torch.no_grad()
    def serve(self, hint_dir, hint_color, hint_label, sentence_mask):
        """One batch of hint triples through the cached path: [B, S] int64
        triples and bool mask on the device -> (cand_w [B, K, 2] f32,
        idx [B, K], scores [B, K])."""
        ids = C.hint_id(hint_dir, hint_color, hint_label)
        text_enc = self.coarse_model.encode_text_from_sentences(
            self.coarse_sent_table[ids], sentence_mask)
        return self._refine_cached(text_enc, self.fine_sent_table[ids], sentence_mask)

    @torch.no_grad()
    def _serve_embedded(self, text: TextSet):
        """Embedded sentences through the cached path: both text trunks in
        full, then the same top-k and cct_tail as `serve`."""
        return self._refine_cached(self.coarse_model.encode_text(text),
                                   self.fine_model.encode_hints(text),
                                   text.sentence_mask)

    @torch.no_grad()
    def _serve_stepwise(self, text: TextSet):
        """The path without a fine cache: the full coarse text trunk, top-k,
        then every candidate cell re-encoded through the whole CrossMatch
        forward with its query's hints, `chunk` cells at a time."""
        scores, rows, ids = self._candidates(self.coarse_model.encode_text(text))
        b, k = rows.shape
        # A padding row's candidate (score -inf, never merged in) re-encodes
        # the last real cell.
        cells = ids.reshape(-1).clamp(max=self.data.num_cells - 1).cpu().numpy()
        rep = torch.arange(b, device=self.device).repeat_interleave(k)
        preds = []
        for s in range(0, b * k, self.chunk):
            sl = slice(s, min(s + self.chunk, b * k))
            objects = object_set(
                self.data.gather_cell_objects(cells[sl], self.cfg.model.pad_size),
                self.cfg.model.pointnet.num_points, self.device)
            r = rep[sl]
            preds.append(self.fine_model(objects, TextSet(
                text.token_embeds[r], text.token_mask[r], text.sentence_mask[r])))
        pred = torch.cat(preds, dim=0).reshape(b, k, 2)
        return self._merge(scores, ids, self._world(pred, rows))

    @staticmethod
    def _result(out, n_real: int) -> LocalizationResult:
        cand_w, idx, scores = out
        cand_w = cand_w.float().cpu().numpy()[:n_real]
        return LocalizationResult(position_w=cand_w[:, 0], candidates_w=cand_w,
                                  cell_indices=idx.cpu().numpy()[:n_real],
                                  scores=scores.cpu().numpy()[:n_real])

    def localize(self, hint_dir, hint_color, hint_label,
                 sentence_mask: Optional[np.ndarray] = None) -> LocalizationResult:
        """hint_*: [B, S] int hint triples -> positions. `sentence_mask`
        ([B, S] bool) marks real hints when a query carries fewer than S."""
        n_real = len(np.asarray(hint_dir))
        pad = self._padder(n_real)
        if sentence_mask is None:
            sentence_mask = np.ones(np.asarray(hint_dir).shape, bool)

        def dev(a, dtype):
            return torch.as_tensor(pad(a), device=self.device).to(dtype)

        triples = (dev(hint_dir, torch.long), dev(hint_color, torch.long),
                   dev(hint_label, torch.long))
        mask = dev(sentence_mask, torch.bool)
        if self.fine_emb is not None:
            return self._result(self.serve(*triples, mask), n_real)
        return self._result(self._serve_stepwise(self.embedder.embed(*triples, mask)),
                            n_real)

    def localize_embedded(self, token_embeds, token_mask,
                          sentence_mask) -> LocalizationResult:
        """Localize from pre-embedded sentences (the online-encoder path):
        token_embeds [B, S, T, E] (E = the towers' text_embed_dim),
        token_mask [B, S, T] real tokens, sentence_mask [B, S] real
        sentences. Both text trunks run in full."""
        token_embeds = np.asarray(token_embeds, np.float32)
        if token_embeds.ndim != 4:
            raise ValueError(f"token_embeds must be [B, S, T, E], got {token_embeds.shape}")
        n_real = len(token_embeds)
        pad = self._padder(n_real)

        def dev(a, dtype):
            return torch.as_tensor(pad(np.asarray(a)), device=self.device).to(dtype)

        text = TextSet(dev(token_embeds, torch.float32), dev(token_mask, torch.bool),
                       dev(sentence_mask, torch.bool))
        if self.fine_emb is not None:
            return self._result(self._serve_embedded(text), n_real)
        return self._result(self._serve_stepwise(text), n_real)

    def localize_text(self, descriptions) -> LocalizationResult:
        """Localize from description strings. Each description is split into
        sentences and parsed against the closed hint-template vocabulary
        (text.parse_descriptions), then served by `localize`. A batch with a
        sentence outside the vocabulary goes, whole, through the online
        encoder and `localize_embedded`; without an online encoder it raises
        `text.HintParseError`. Descriptions shorter than `num_mentioned` are
        padded and masked either way."""
        from text2loc_tpu_torch.text import (HintParseError, parse_descriptions,
                                             split_description)

        s_max = self.cfg.model.num_mentioned
        try:
            parsed = parse_descriptions(descriptions, num_mentioned=s_max)
        except HintParseError:
            if self.online_encoder is None:
                raise
        else:
            return self.localize(parsed["hint_dir"], parsed["hint_color"],
                                 parsed["hint_label"],
                                 sentence_mask=parsed["sentence_mask"])

        sent_lists = [split_description(d)[:s_max] for d in descriptions]
        if any(len(sl) == 0 for sl in sent_lists):
            raise HintParseError("empty description")
        emb, tmask = self.online_encoder.encode([s for sl in sent_lists for s in sl])
        emb, tmask = np.asarray(emb, np.float32), np.asarray(tmask, bool)
        t, e = emb.shape[1:]
        b = len(sent_lists)
        token_embeds = np.zeros((b, s_max, t, e), np.float32)
        token_mask = np.zeros((b, s_max, t), bool)
        sentence_mask = np.zeros((b, s_max), bool)
        pos = 0
        for i, sl in enumerate(sent_lists):
            n = len(sl)
            token_embeds[i, :n] = emb[pos:pos + n]
            token_mask[i, :n] = tmask[pos:pos + n]
            sentence_mask[i, :n] = True
            pos += n
        return self.localize_embedded(token_embeds, token_mask, sentence_mask)
