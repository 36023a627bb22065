"""Gallery and query encoding and top-k retrieval (port of
text2loc_tpu/evaluation/retrieval.py: topk_retrieval, encode_gallery,
encode_queries, encode_queries_table, build_vocab_sentence_table,
eval_retrieval; and of the eval side of text2loc_tpu/training/steps.py:
make_coarse_encoders, encode_fine_gallery)."""

from __future__ import annotations

import numpy as np
import torch

from text2loc_tpu_torch.data.augment import point_cloud_transform_eval
from text2loc_tpu_torch.data.batch import ObjectSet, TextSet

GALLERY_CHUNK = 64   # cells per coarse-gallery encoder call
FINE_CHUNK = 128     # cells per fine-cache encoder call


def topk_retrieval(cell_enc: torch.Tensor, text_enc: torch.Tensor, k: int):
    """(scores [Q, k], indices [Q, k]) by descending inner product in f32.
    Equal scores keep the lowest gallery index first, as lax.top_k does
    (a stable descending sort; torch.topk promises no order on ties)."""
    scores = text_enc.float() @ cell_enc.float().t()
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def object_set(batch: dict, num_points: int, device) -> ObjectSet:
    """ObjectSet on `device` from a host batch of
    MultiSceneArrays.gather_cell_objects, through the eval point transform."""
    def t(name):
        return torch.as_tensor(np.asarray(batch[name]), device=device)

    xyz, rgb = point_cloud_transform_eval(t("xyz").float(), t("rgb").float(),
                                          num_points)
    return ObjectSet(xyz=xyz, rgb=rgb, center=t("center").float(),
                     color=t("color").float(), num_points=t("num_points").float(),
                     class_idx=t("class_idx").long(), color_idx=t("color_idx").long(),
                     mask=t("mask").bool())


def _chunks(n: int, chunk: int):
    for start in range(0, n, chunk):
        yield np.arange(start, min(start + chunk, n))


@torch.no_grad()
def encode_gallery(data, model, cfg, device) -> torch.Tensor:
    """[C, coarse D] f32 embeddings of every gallery cell
    (CellRetrievalNetwork.encode_objects over object_size slots)."""
    rows = []
    for ids in _chunks(data.num_cells, GALLERY_CHUNK):
        objects = object_set(data.gather_cell_objects(ids, cfg.model.object_size),
                             cfg.model.pointnet.num_points, device)
        rows.append(model.encode_objects(objects))
    return torch.cat(rows, dim=0)


@torch.no_grad()
def encode_fine_gallery(data, model, cfg, device, cell_indices=None):
    """(cell_emb [C, pad, D], cell_mask [C, pad]) of the gallery cells (all,
    or `cell_indices`) for the fine stage: CrossMatch.encode_objects over
    pad_size slots, then the CCT's layer-0 object self-attention block
    (cct_obj_pre), a pure function of the cell that the serve caches."""
    pad = cfg.model.pad_size
    cells = np.arange(data.num_cells) if cell_indices is None else np.asarray(cell_indices)
    rows = []
    for ids in _chunks(len(cells), FINE_CHUNK):
        objects = object_set(data.gather_cell_objects(cells[ids], pad),
                             cfg.model.pointnet.num_points, device)
        rows.append(model.cct_obj_pre(model.encode_objects(objects), objects.mask))
    mask = torch.as_tensor(np.asarray(data.obj_mask[cells, :pad]), device=device).bool()
    return torch.cat(rows, dim=0), mask


def _hint_batch(data, ids, device) -> dict:
    return {name: torch.as_tensor(np.asarray(getattr(data, src)[ids]), device=device)
            for name, src in (("hint_dir", "hint_dir"), ("hint_color", "hint_color"),
                              ("hint_label", "hint_label"), ("sentence_mask", "hint_mask"))}


@torch.no_grad()
def encode_queries(data, model, embedder, cfg, device) -> torch.Tensor:
    """[Q, coarse D] f32 embeddings of every pose's hint set, through the
    full text trunk (CellRetrievalNetwork.encode_text), in chunks of
    cfg.eval.batch_size poses."""
    rows = []
    for ids in _chunks(data.num_poses, cfg.eval.batch_size):
        b = _hint_batch(data, ids, device)
        rows.append(model.encode_text(embedder.embed(
            b["hint_dir"], b["hint_color"], b["hint_label"], b["sentence_mask"])))
    return torch.cat(rows, dim=0).float()


@torch.no_grad()
def encode_queries_table(data, model, embedder, cfg, device) -> torch.Tensor:
    """encode_queries through the [V, D] sentence table: each query costs a
    row gather and the cross-sentence head (the per-sentence trunk is a pure
    function of the sentence at eval)."""
    from text2loc_tpu_torch import constants as C

    table = build_vocab_sentence_table(embedder, model.encode_text_sentences)
    rows = []
    for ids in _chunks(data.num_poses, cfg.eval.batch_size):
        b = _hint_batch(data, ids, device)
        sent = table[C.hint_id(b["hint_dir"].long(), b["hint_color"].long(),
                               b["hint_label"].long())]
        rows.append(model.encode_text_from_sentences(sent, b["sentence_mask"].bool()))
    return torch.cat(rows, dim=0).float()


@torch.no_grad()
def eval_retrieval(data, model, embedder, cfg, top_k=None, device="cuda"):
    """Coarse retrieval over the whole gallery (port of the single-device
    branch of text2loc_tpu/evaluation/retrieval.py:eval_retrieval): the
    gallery and the queries encoded (the queries through the sentence table
    with cfg.eval.sentence_table), top-k by inner product.

    Returns (top-k recall {k: r}, close recall {k: r}, retrieved gallery
    indices [Q, min(max k, C)] as numpy). `model` is in eval mode on
    `device`; `embedder` lies on `device`."""
    from text2loc_tpu_torch.evaluation import metrics

    top_k = tuple(top_k) if top_k is not None else cfg.train.top_k
    cell_enc = encode_gallery(data, model, cfg, device)
    encode = encode_queries_table if cfg.eval.sentence_table else encode_queries
    text_enc = encode(data, model, embedder, cfg, device)
    k = min(max(top_k), data.num_cells)
    _, idx = topk_retrieval(cell_enc, text_enc, k)
    idx = idx.cpu().numpy()
    acc, acc_close = metrics.retrieval_accuracies(
        retrieved_cell_idx=idx, target_cell_idx=data.pose_cell_idx,
        pose_w=data.pose_w[:, :2], cell_centers=data.cell_centers,
        cell_size=float(data.cell_size[0]), top_k=top_k)
    return acc, acc_close, idx


@torch.no_grad()
def build_vocab_sentence_table(embedder, method) -> torch.Tensor:
    """[V, D] per-sentence trunk outputs over the closed hint vocabulary;
    `method` is CellRetrievalNetwork.encode_text_sentences (coarse) or
    CrossMatch.encode_hints (fine)."""
    v = embedder.table.shape[0]
    vocab = TextSet(
        token_embeds=embedder.table[:, None],
        token_mask=embedder.token_mask[:, None],
        sentence_mask=torch.ones((v, 1), dtype=torch.bool,
                                 device=embedder.table.device),
    )
    return method(vocab)[:, 0]
