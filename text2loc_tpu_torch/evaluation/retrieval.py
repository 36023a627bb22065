"""Gallery encoding and top-k retrieval (port of
text2loc_tpu/evaluation/retrieval.py: topk_retrieval, encode_gallery,
build_vocab_sentence_table; and of the eval side of
text2loc_tpu/training/steps.py: make_coarse_encoders, encode_fine_gallery)."""

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
def encode_fine_gallery(data, model, cfg, device):
    """(cell_emb [C, pad, D], cell_mask [C, pad]) of every gallery cell for the
    fine stage: CrossMatch.encode_objects over pad_size slots, then the CCT's
    layer-0 object self-attention block (cct_obj_pre), a pure function of the
    cell that the serve caches."""
    pad = cfg.model.pad_size
    rows = []
    for ids in _chunks(data.num_cells, FINE_CHUNK):
        objects = object_set(data.gather_cell_objects(ids, pad),
                             cfg.model.pointnet.num_points, device)
        rows.append(model.cct_obj_pre(model.encode_objects(objects), objects.mask))
    mask = torch.as_tensor(np.asarray(data.obj_mask[:, :pad]), device=device).bool()
    return torch.cat(rows, dim=0), mask


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
