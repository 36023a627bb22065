"""Weights for the port: conversion from the JAX package's parameter trees,
and the port's own seeded initialization.

Layout rules of the conversion (JAX tree -> port state dict):

* flax Dense kernels are [in, out]; the port's nn.Linear weights are
  [out, in] (transposed);
* the attention DenseGeneral kernels q/k/v [D, H, DH] become [D, H*DH] and
  out [H, DH, D] becomes [H*DH, D]; their biases flatten the same way;
  the transformer feed-forward kernels stay [in, out] (Projection);
* SA levels name their parameters dense_{l}_kernel / bn_{l}_scale /
  bn_{l}_mean ...; the port holds modules dense_{l} / bn_{l};
* LayerNorm / BatchNorm `scale` is the port's `weight`; the BN batch
  statistics `mean` / `var` are the running_mean / running_var buffers;
* layer lists intra_0, cross_hints_1, ... are ModuleList entries, and the
  global abstraction's auto-named MLP_0 is `mlp`.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

_LIST = re.compile(r"^(intra|inter|obj_inter|cross_hints|cross_objects)_(\d+)$")
_SA = re.compile(r"^(dense|bn)_(\d+)_(kernel|bias|scale|mean|var)$")
_HEADS = ("query", "key", "value")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _module_path(path):
    out = []
    for seg in path:
        m = _LIST.match(seg)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else
                   ("mlp" if seg == "MLP_0" else seg))
    return out


def _convert_leaf(path, arr):
    *mods, last = path
    parent = mods[-1] if mods else ""
    m = _SA.match(last)
    if m:
        mods, last = mods + [f"{m.group(1)}_{m.group(2)}"], m.group(3)
        parent = mods[-1]
    name = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[last]
    if last == "kernel":
        if parent in _HEADS:
            arr = arr.reshape(arr.shape[0], -1)
        elif parent == "out":
            arr = arr.reshape(-1, arr.shape[-1])
        elif parent not in ("linear1", "linear2"):
            arr = arr.T                       # flax Dense -> nn.Linear
    elif last == "bias" and parent in _HEADS:
        arr = arr.reshape(-1)
    return ".".join(_module_path(mods) + [name]), np.ascontiguousarray(arr)


def convert_tree(params, batch_stats) -> dict:
    """Port state dict entries for any JAX module tree (numpy or jax
    arrays), by the layout rules above."""
    state = {}
    for tree in (params, batch_stats):
        for path, arr in _flatten(tree):
            key, val = _convert_leaf(path, arr)
            state[key] = torch.tensor(val)
    return state


def from_jax_params(params, batch_stats, cfg, kind: str) -> dict:
    """The port's state dict for a JAX CellRetrievalNetwork ("coarse") or
    CrossMatch ("fine") from its `params` / `batch_stats` trees (numpy or
    jax arrays). Checked against the port's model of that kind: a missing,
    extra or mis-shaped entry raises."""
    state = convert_tree(params, batch_stats)
    want = build_model(cfg, kind).state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    bad = sorted(k for k in set(want) & set(state)
                 if tuple(want[k].shape) != tuple(state[k].shape))
    if missing or extra or bad:
        raise ValueError(f"JAX {kind} tree does not fit the port: missing "
                         f"{missing[:5]}, extra {extra[:5]}, shape {bad[:5]}")
    return state


def build_model(cfg, kind: str, sa_mode="first", approx_neighbors=None,
                bisect_iters: int = 12, fused_train=None, fused_attn: str = "1",
                fused_ffn: str = "1", fused_ln: str = "1",
                vmem_gather: bool = False) -> nn.Module:
    """A port model of `kind` ("coarse" or "fine") for the Config `cfg`, with
    PointNet2's inference SA options and vmem_gather (models/pointnet2.py),
    the training SA tokens `fused_train` (None: the stage's default,
    training/steps.default_fused_train) and the transformer gates
    fused_attn / fused_ffn / fused_ln ("0" | "1" | "all",
    models/transformer.py): the JAX package's TEXT2LOC_* switches as
    arguments."""
    from text2loc_tpu_torch.models.cell_retrieval import CellRetrievalNetwork
    from text2loc_tpu_torch.models.cross_matcher import CrossMatch
    from text2loc_tpu_torch.models.transformer import Gates
    from text2loc_tpu_torch.training.steps import default_fused_train

    if kind not in ("coarse", "fine"):
        raise ValueError(f"kind {kind!r}: expected 'coarse' or 'fine'")
    if fused_train is None:
        fused_train = default_fused_train(cfg, kind)
    opts = dict(sa_mode=sa_mode, approx_neighbors=approx_neighbors,
                bisect_iters=bisect_iters, fused_train=fused_train,
                gates=Gates(attn=fused_attn, ffn=fused_ffn, ln=fused_ln),
                vmem_gather=vmem_gather)
    if kind == "coarse":
        return CellRetrievalNetwork(cfg.model, **opts)
    return CrossMatch(cfg.model, **opts)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for a port model: 1/sqrt(fan_in) normal
    matrices, small random biases, LayerNorm/BatchNorm affines near
    identity, and BatchNorm running statistics away from 0/1 (so the folded
    eval BN is exercised). The fine offset head starts near the cell centre
    (bias 0.5, small last-layer weights), as a trained regressor predicts
    positions inside the cell. `generator` is a CPU torch.Generator."""
    from text2loc_tpu_torch.models.mlp import MaskedBatchNorm
    from text2loc_tpu_torch.models.transformer import Projection

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=generator) * std + mean)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            normal(mod.weight, 1.0 / math.sqrt(mod.in_features))
            normal(mod.bias, 0.02)
        elif isinstance(mod, Projection):
            normal(mod.weight, 1.0 / math.sqrt(mod.weight.shape[0]))
            normal(mod.bias, 0.02)
        elif isinstance(mod, nn.LayerNorm):
            normal(mod.weight, 0.1, 1.0)
            normal(mod.bias, 0.1)
        elif isinstance(mod, MaskedBatchNorm):
            normal(mod.weight, 0.1, 1.0)
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            mod.running_var.copy_(
                0.5 + torch.rand(mod.running_var.shape, generator=generator))
    head = getattr(model, "mlp_offsets", None)
    if head is not None:
        last = getattr(head, f"dense_{head.n_layers - 1}")
        last.weight.mul_(0.05)
        last.bias.fill_(0.5)
    return model
