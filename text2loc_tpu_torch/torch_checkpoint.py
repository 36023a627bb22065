"""Reference-layout PyTorch checkpoints (the published coarse.pth /
fine.pth) loaded into the port's models.

The port's own copy of the full-model converters of
text2loc_tpu/models/torch_convert.py (numpy only): a reference state dict
is mapped onto the JAX package's parameter-tree layout, and convert.py's
convert_tree takes that tree to the port's state-dict keys, so one set of
layout rules serves both weight sources. Loading follows the reference's
load_state_dict(strict=False): what the checkpoint lacks (the frozen T5
weights were stripped when it was saved) keeps the model's current values.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def to_numpy(state_dict: Mapping) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in state_dict.items()}


def convert_linear(sd, prefix: str) -> Dict:
    """nn.Linear -> {kernel [in, out], bias}."""
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def convert_layernorm(sd, prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def convert_batchnorm(sd, prefix: str):
    """nn.BatchNorm1d -> (params, batch_stats)."""
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})


def convert_mha(sd, prefix: str, num_heads: int) -> Dict:
    """nn.MultiheadAttention (q/k/v packed in in_proj_weight [3D, D]) ->
    per-head kernels [D, H, Dh] and out [H, Dh, D]."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    dh = d // num_heads
    out = {}
    for i, name in enumerate(("query", "key", "value")):
        out[name] = {
            "kernel": np.ascontiguousarray(w[i * d:(i + 1) * d].T).reshape(d, num_heads, dh),
            "bias": b[i * d:(i + 1) * d].reshape(num_heads, dh),
        }
    out["out"] = {
        "kernel": np.ascontiguousarray(sd[f"{prefix}.out_proj.weight"].T).reshape(
            num_heads, dh, d),
        "bias": sd[f"{prefix}.out_proj.bias"],
    }
    return out


def convert_encoder_layer(sd, prefix: str, num_heads: int) -> Dict:
    """nn.TransformerEncoderLayer."""
    p = f"{prefix}." if prefix else ""
    return {"self_attn": convert_mha(sd, f"{p}self_attn", num_heads),
            "linear1": convert_linear(sd, f"{p}linear1"),
            "linear2": convert_linear(sd, f"{p}linear2"),
            "norm1": convert_layernorm(sd, f"{p}norm1"),
            "norm2": convert_layernorm(sd, f"{p}norm2")}


def convert_decoder_layer(sd, prefix: str, num_heads: int) -> Dict:
    """nn.TransformerDecoderLayer."""
    p = f"{prefix}." if prefix else ""
    return {"self_attn": convert_mha(sd, f"{p}self_attn", num_heads),
            "cross_attn": convert_mha(sd, f"{p}multihead_attn", num_heads),
            "linear1": convert_linear(sd, f"{p}linear1"),
            "linear2": convert_linear(sd, f"{p}linear2"),
            "norm1": convert_layernorm(sd, f"{p}norm1"),
            "norm2": convert_layernorm(sd, f"{p}norm2"),
            "norm3": convert_layernorm(sd, f"{p}norm3")}


def _mlp_layer_prefixes(sd, prefix: str, batchnorm: bool = True):
    """(linear prefix, BN prefix or None) per layer of a reference MLP: the
    nested Sequential(Sequential(Linear, BN, ReLU), ...) of get_mlp
    (`{p}{i}.0.weight`), or a flat Sequential (`{p}{3i}.weight` with BN,
    `{p}{2i}.weight` without)."""
    p = f"{prefix}." if prefix else ""
    layers = []
    if f"{p}0.0.weight" in sd:
        i = 0
        while f"{p}{i}.0.weight" in sd:
            bn = f"{p}{i}.1" if f"{p}{i}.1.running_mean" in sd else None
            layers.append((f"{p}{i}.0", bn))
            i += 1
    else:
        stride = 3 if batchnorm else 2
        i = 0
        while f"{p}{stride * i}.weight" in sd:
            bn = (f"{p}{stride * i + 1}"
                  if f"{p}{stride * i + 1}.running_mean" in sd else None)
            layers.append((f"{p}{stride * i}", bn))
            i += 1
    if not layers:
        raise KeyError(f"no MLP weights under {prefix!r}")
    return layers


def convert_mlp(sd, prefix: str, batchnorm: bool = True):
    """A reference get_mlp / get_mlp2 / get_mlp_offset -> (params, stats)."""
    params: Dict = {}
    stats: Dict = {}
    for i, (lin, bn) in enumerate(_mlp_layer_prefixes(sd, prefix, batchnorm=batchnorm)):
        params[f"dense_{i}"] = convert_linear(sd, lin)
        if bn is not None:
            params[f"bn_{i}"], stats[f"bn_{i}"] = convert_batchnorm(sd, bn)
    return params, stats


def convert_pointnet_checkpoint(sd, num_sa: int = 3):
    """The reference PointNet2 (sa{i}.point_conv.local_nn, ga.mlp, lin1,
    lin2, class_classifier, color_classifier) -> (params, stats); each SA
    level's MLP flattened to dense_{l}_kernel / bn_{l}_mean ..."""

    def has_mlp(prefix: str) -> bool:
        return f"{prefix}.0.weight" in sd or f"{prefix}.0.0.weight" in sd

    params: Dict = {}
    stats: Dict = {}
    for i in range(1, num_sa + 1):
        for cand in (f"sa{i}.point_conv.local_nn", f"sa{i}.point_conv.nn"):
            if has_mlp(cand):
                p, s = convert_mlp(sd, cand, batchnorm=True)
                break
        else:
            raise KeyError(f"sa{i} local_nn not found")
        flat_p, flat_s = {}, {}
        for l in range(len(p) // 2):
            flat_p[f"dense_{l}_kernel"] = p[f"dense_{l}"]["kernel"]
            flat_p[f"dense_{l}_bias"] = p[f"dense_{l}"]["bias"]
            flat_p[f"bn_{l}_scale"] = p[f"bn_{l}"]["scale"]
            flat_p[f"bn_{l}_bias"] = p[f"bn_{l}"]["bias"]
            flat_s[f"bn_{l}_mean"] = s[f"bn_{l}"]["mean"]
            flat_s[f"bn_{l}_var"] = s[f"bn_{l}"]["var"]
        params[f"sa{i}"] = flat_p
        stats[f"sa{i}"] = flat_s
    for cand in ("ga.mlp", "ga.nn", "ga.local_nn"):
        if has_mlp(cand):
            p, s = convert_mlp(sd, cand, batchnorm=True)
            break
    else:
        raise KeyError("global abstraction MLP not found")
    params["ga"] = {"MLP_0": p}
    stats["ga"] = {"MLP_0": s}
    for name in ("lin1", "lin2", "class_classifier", "color_classifier"):
        params[name] = convert_linear(sd, name)
    return params, stats


def _subdict(sd, prefix: str) -> Dict[str, np.ndarray]:
    p = f"{prefix}."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def convert_object_encoder(sd, prefix: str, cfg):
    """Reference ObjectEncoder -> (params, stats): the PointNet path, or
    with `class_embed` / `color_embed` the embedding tables."""
    from text2loc_tpu_torch import constants as C

    p = f"{prefix}." if prefix else ""
    params: Dict = {}
    stats: Dict = {}
    use = cfg.use_features

    def mlp(name):
        params[name], ms = convert_mlp(sd, f"{p}{name}")
        if ms:
            stats[name] = ms

    if "class" in use and not cfg.class_embed:
        pn_sd = _subdict(sd, f"{p}pointnet")
        if pn_sd:
            params["pointnet"], stats["pointnet"] = convert_pointnet_checkpoint(pn_sd)
        mlp("mlp_pointnet")
    elif "class" in use:
        # The reference's class rows are in ALPHABETICAL order (known_classes
        # = {c: i + 1 for c in np.unique(labels)}, "<unk>" at 0); the port
        # indexes class_idx + 1 in CLASS_TO_INDEX order: permute the rows.
        w = np.asarray(sd[f"{p}class_embedding.weight"])
        tbl = np.zeros_like(w)
        tbl[0] = w[0]
        for c, j in C.CLASS_TO_INDEX.items():
            tbl[j + 1] = w[C.KNOWN_CLASSES.index(c) + 1]
        params["class_embedding"] = {"embedding": tbl}
    if "color" in use and cfg.color_embed:
        # The reference keys colours by NAME, {c: i for i, c in
        # enumerate(COLOR_NAMES)} plus "<unk>": 0, looked up without + 1:
        # the second "gray" wins (row 1 unreachable) and "dark-green" shares
        # row 0 with "<unk>". The port's row j + 1 takes that row.
        w = np.asarray(sd[f"{p}color_embedding.weight"])
        ref_idx = {name: i for i, name in enumerate(C.COLOR_NAMES)}
        tbl = np.zeros((C.NUM_COLORS + 1, w.shape[1]), w.dtype)
        for j, name in enumerate(C.COLOR_NAMES):
            tbl[j + 1] = w[ref_idx[name]]
        params["color_embedding"] = {"embedding": tbl}
    elif "color" in use:
        mlp("color_encoder")
    if "position" in use:
        mlp("pos_encoder")
    if "num" in use:
        mlp("num_encoder")
    if len(use) > 1:
        mlp("mlp_merge")
    return params, stats


def convert_language_encoder(sd, prefix: str, is_fine: bool, intra_num_heads: int,
                             inter_num_heads: int = 4):
    """Reference LanguageEncoder without its frozen T5 (llm_model.* keys are
    ignored): intra_module.{i} -> intra_{i}, inter_mlp, and for the coarse
    tower inter_module.{i} -> inter_{i}."""
    p = f"{prefix}." if prefix else ""
    params: Dict = {}
    stats: Dict = {}
    i = 0
    while f"{p}intra_module.{i}.self_attn.in_proj_weight" in sd:
        params[f"intra_{i}"] = convert_encoder_layer(sd, f"{p}intra_module.{i}",
                                                     intra_num_heads)
        i += 1
    if i == 0:
        raise KeyError(f"no intra_module layers under {prefix!r}")
    params["inter_mlp"], ms = convert_mlp(sd, f"{p}inter_mlp")
    if ms:
        stats["inter_mlp"] = ms
    if not is_fine:
        i = 0
        while f"{p}inter_module.{i}.self_attn.in_proj_weight" in sd:
            params[f"inter_{i}"] = convert_encoder_layer(sd, f"{p}inter_module.{i}",
                                                         inter_num_heads)
            i += 1
        if i == 0:
            raise KeyError(f"no inter_module layers under {prefix!r}")
    return params, stats


def convert_cell_retrieval_checkpoint(sd, cfg):
    """Published coarse checkpoint -> CellRetrievalNetwork (params, stats)
    for ModelConfig `cfg`."""
    params: Dict = {}
    stats: Dict = {}
    params["object_encoder"], oe_s = convert_object_encoder(sd, "object_encoder", cfg)
    if oe_s:
        stats["object_encoder"] = oe_s
    i = 0
    while f"obj_inter_module.{i}.self_attn.in_proj_weight" in sd:
        params[f"obj_inter_{i}"] = convert_encoder_layer(sd, f"obj_inter_module.{i}",
                                                         cfg.object_inter_num_heads)
        i += 1
    if i != cfg.object_inter_num_layers:
        raise KeyError(f"checkpoint has {i} obj_inter layers, config expects "
                       f"{cfg.object_inter_num_layers}")
    params["language_encoder"], le_s = convert_language_encoder(
        sd, "language_encoder", is_fine=False, intra_num_heads=cfg.intra_num_heads,
        inter_num_heads=cfg.inter_num_heads)
    if le_s:
        stats["language_encoder"] = le_s
    return params, stats


def convert_cross_matcher_checkpoint(sd, cfg):
    """Published fine checkpoint -> CrossMatch (params, stats): paired
    cross_objects.{i} / cross_hints.{i} decoder stacks, or one bare
    `cross_hints` layer when fine_num_decoder_layers == 0, and mlp_offsets."""
    params: Dict = {}
    stats: Dict = {}
    params["object_encoder"], oe_s = convert_object_encoder(sd, "object_encoder", cfg)
    if oe_s:
        stats["object_encoder"] = oe_s
    params["language_encoder"], le_s = convert_language_encoder(
        sd, "language_encoder", is_fine=True, intra_num_heads=cfg.fine_intra_num_heads)
    if le_s:
        stats["language_encoder"] = le_s
    heads = cfg.fine_num_decoder_heads
    if "cross_hints.self_attn.in_proj_weight" in sd:
        params["cross_hints_0"] = convert_decoder_layer(sd, "cross_hints", heads)
    else:
        i = 0
        while f"cross_hints.{i}.self_attn.in_proj_weight" in sd:
            params[f"cross_hints_{i}"] = convert_decoder_layer(sd, f"cross_hints.{i}", heads)
            params[f"cross_objects_{i}"] = convert_decoder_layer(
                sd, f"cross_objects.{i}", heads)
            i += 1
        if i != cfg.fine_num_decoder_layers:
            raise KeyError(f"checkpoint has {i} decoder layers, config expects "
                           f"{cfg.fine_num_decoder_layers}")
    params["mlp_offsets"], _ = convert_mlp(sd, "mlp_offsets", batchnorm=False)
    return params, stats


def reference_state_dict(sd: Mapping, cfg, kind: str) -> dict:
    """The port's state-dict entries of a reference-layout state dict for
    tower `kind` ("coarse" or "fine") of ModelConfig `cfg`."""
    from text2loc_tpu_torch.convert import convert_tree

    sd = to_numpy(sd)
    if kind == "coarse":
        params, stats = convert_cell_retrieval_checkpoint(sd, cfg)
    elif kind == "fine":
        params, stats = convert_cross_matcher_checkpoint(sd, cfg)
    else:
        raise ValueError(f"kind {kind!r}: expected 'coarse' or 'fine'")
    return convert_tree(params, stats)


def load_reference_checkpoint(model: torch.nn.Module, path: str, cfg, kind: str):
    """Load a reference-layout .pth into `model` with strict=False semantics:
    entries the checkpoint lacks keep their values; an entry the model does
    not have, or of another shape, raises. Returns the model."""
    state = reference_state_dict(torch.load(path, map_location="cpu", weights_only=False),
                                 cfg, kind)
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    bad = sorted(k for k in set(state) & set(own)
                 if tuple(state[k].shape) != tuple(own[k].shape))
    if extra or bad:
        raise ValueError(f"{path}: entries that do not fit the {kind} model: extra "
                         f"{extra[:5]}, shape {bad[:5]}")
    model.load_state_dict(state, strict=False)
    return model


def load_pretrained_pointnet(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Graft a reference-layout PointNet checkpoint (the published
    pointnet_acc0.86_lr1_p256.pth layout) into a tower's
    object_encoder.pointnet, parameters and BatchNorm running statistics
    (port of text2loc_tpu/models/torch_convert.py:load_pretrained_pointnet);
    every other entry of `model` keeps its value. A tower without a PointNet
    (`class_embed`) is refused. Returns the model."""
    from text2loc_tpu_torch.convert import convert_tree

    if not hasattr(getattr(model, "object_encoder", None), "pointnet"):
        raise ValueError(f"{path}: the tower has no PointNet to graft into "
                         "(its object encoder uses the class embedding table)")
    sd = to_numpy(torch.load(path, map_location="cpu", weights_only=True))
    params, stats = convert_pointnet_checkpoint(sd)
    state = {f"object_encoder.pointnet.{k}": v
             for k, v in convert_tree(params, stats).items()}
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    bad = sorted(k for k in set(state) & set(own)
                 if tuple(state[k].shape) != tuple(own[k].shape))
    missing = sorted(k for k in own
                     if k.startswith("object_encoder.pointnet.") and k not in state)
    if extra or bad or missing:
        raise ValueError(f"{path}: does not fit the tower's PointNet: extra {extra[:5]}, "
                         f"shape {bad[:5]}, missing {missing[:5]}")
    model.load_state_dict(state, strict=False)
    return model
