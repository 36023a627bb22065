"""Post-LN transformer layers with key-padding masks (port of
text2loc_tpu/models/transformer.py: TorchEncoderLayer, TorchDecoderLayer).

In eval, where the JAX package runs its fused Pallas blocks, the port runs
its fused blocks (ops/mha.py, ops/ffn.py, ops/ln.py: the CUDA kernel on the
card, the plain version on the CPU), under the JAX gates. The JAX package
reads them from TEXT2LOC_FUSED_ATTN / TEXT2LOC_FUSED_FFN / TEXT2LOC_FUSED_LN;
the port takes them as constructor arguments (Gates), each "0" (off), "1"
(the default) or "all":

* attention block (fused_attn_enabled): d_model a multiple of 128, query
  and memory widths equal to d_model; "1": d_model <= 256, or <= 1024 with
  bf16 activations; "all": every such d_model;
* feed-forward block (fused_ffn_enabled): d_model and the hidden width
  multiples of 128; "1": d_model <= 256; "all": every such d_model;
* add + LayerNorm after a stock block (fused_ln_enabled): d_model a
  multiple of 128; "1": d_model <= 256; "all": every such d_model.

A block whose gate is closed runs as stock tensor ops, what the JAX package
leaves to XLA. A gate that is open runs the kernel (on the card the
attention and feed-forward blocks each by their route: the fused kernel to
d_model 256, the tiled chain above), and on the card a kernel that cannot
take the shape raises rather than falling back.
In training (module.train()) every fused gate closes and the stock ops run
with dropout at the torch positions: the attention weights, the attention
output, the feed-forward hidden after the ReLU and the feed-forward output.
Dropout draws from the generator set with set_dropout_generator (under a
data-parallel mesh, at the global batch's shape: parallel/mesh.local_draw).
Weights of the blocks are stored [in, out], the layout the kernels read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from text2loc_tpu_torch.ops.ffn import ffn_addln
from text2loc_tpu_torch.ops.ln import add_layernorm as fused_add_layernorm
from text2loc_tpu_torch.ops.mha import mha_addln
from text2loc_tpu_torch.parallel.mesh import local_draw

LN_EPS = 1e-5
GATE_VALUES = ("0", "1", "all")


@dataclass(frozen=True)
class Gates:
    """The fused-block gates of a layer: the values of the JAX package's
    TEXT2LOC_FUSED_ATTN, TEXT2LOC_FUSED_FFN and TEXT2LOC_FUSED_LN."""

    attn: str = "1"
    ffn: str = "1"
    ln: str = "1"

    def __post_init__(self):
        for name in ("attn", "ffn", "ln"):
            v = getattr(self, name)
            if v not in GATE_VALUES:
                raise ValueError(f"fused_{name}={v!r}: expected one of {GATE_VALUES}")


def fused_ln_enabled(d: int, value: str) -> bool:
    """The JAX package's _fused_ln_enabled (transformer.py:78-85), minus its
    backend and environment checks."""
    return value != "0" and (d <= 256 or value == "all")


def fused_ffn_enabled(d: int, value: str) -> bool:
    """The JAX package's _fused_ffn_enabled (transformer.py:88-95)."""
    return value != "0" and (d <= 256 or value == "all")


def fused_attn_enabled(d: int, dtype, value: str) -> bool:
    """The JAX package's _fused_attn_enabled (transformer.py:98-119), with
    `dtype` the activations' dtype."""
    if value == "0":
        return False
    if value == "all" or d <= 256:
        return True
    return d <= 1024 and dtype == torch.bfloat16


class Dropout(nn.Module):
    """Inverted dropout (keep with 1 - p, scale 1 / (1 - p)) in training,
    drawing its mask from `generator` (a torch.Generator on the tensors'
    device; None = the default one). The identity in eval or at p = 0.
    `mesh` (set by parallel/mesh.use_mesh): the mask is drawn for the global
    batch (leading axis), and this rank keeps its rows."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None
        self.mesh = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = local_draw(lambda shape: torch.rand(shape, generator=self.generator,
                                                   device=x.device),
                          x.shape, self.mesh) >= self.p
        return x * keep.to(x.dtype) / torch.tensor(1.0 - self.p, dtype=x.dtype,
                                                    device=x.device)


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Make every Dropout of `model` draw from `generator`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


class Projection(nn.Module):
    """Dense layer stored [in, out] (flax layout): y = x @ weight + bias."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(d_in))

    def forward(self, x, dtype):
        return x.to(dtype) @ self.weight.to(dtype) + self.bias.to(dtype)


class MultiheadAttentionParams(nn.Module):
    """q/k/v/out projections, [D, H*DH] and [H*DH, D] (the flax DenseGeneral
    kernels with the head axes flattened)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = Projection(d_model, d_model)
        self.key = Projection(d_model, d_model)
        self.value = Projection(d_model, d_model)
        self.out = Projection(d_model, d_model)


def add_layernorm(x, res, norm: nn.LayerNorm, out_dtype):
    """LayerNorm(x + res), the JAX package's stock branch: the sum in x's
    dtype, then f32 statistics, biased variance."""
    s = (x + res).float()
    mu = s.mean(dim=-1, keepdim=True)
    var = torch.square(s - mu).mean(dim=-1, keepdim=True)
    y = (s - mu) * torch.rsqrt(var + LN_EPS)
    return (y * norm.weight + norm.bias).to(out_dtype)


def apply_add_layernorm(x, res, norm: nn.LayerNorm, out_dtype, fused_ln: str,
                        training: bool):
    """LayerNorm(x + res) after a stock block: the add+LN kernel (ops/ln.py,
    output in x's dtype) in eval where the LN gate opens, else the stock
    formula (transformer.py:336-347)."""
    d = x.shape[-1]
    if not training and d % 128 == 0 and fused_ln_enabled(d, fused_ln):
        return fused_add_layernorm(x, res.to(x.dtype), norm.weight, norm.bias, LN_EPS)
    return add_layernorm(x, res, norm, out_dtype)


def _stock_attention(x, kv, p: MultiheadAttentionParams, key_mask, dtype,
                     dropout: Dropout):
    """flax's DenseGeneral projections + dot_product_attention in `dtype`
    (dropout on the attention weights)."""
    b, lq, d = x.shape
    lk = kv.shape[1]
    h = p.num_heads
    dh = d // h
    q = p.query(x, dtype).reshape(b, lq, h, dh)
    k = p.key(kv, dtype).reshape(b, lk, h, dh)
    v = p.value(kv, dtype).reshape(b, lk, h, dh)
    q = q / torch.sqrt(torch.tensor(float(dh), dtype=dtype))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if key_mask is not None:
        s = torch.where(key_mask.to(torch.bool)[:, None, None, :], s,
                        torch.full((), torch.finfo(dtype).min, dtype=s.dtype,
                                   device=s.device))
    w = dropout(torch.softmax(s, dim=-1).to(dtype))
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, d)
    return p.out(o, dtype)


def attention_block(x, kv, key_mask, attn: MultiheadAttentionParams,
                    norm: nn.LayerNorm, dtype, dropout: Dropout, gates: Gates):
    """LayerNorm(x + Dropout(MHA(x, kv))) — pass `kv is x` for
    self-attention."""
    d = attn.query.weight.shape[1]
    if (not dropout.training and d % 128 == 0 and x.shape[-1] == d == kv.shape[-1]
            and fused_attn_enabled(d, x.dtype, gates.attn)):
        return mha_addln(
            x, kv, attn.query.weight, attn.query.bias, attn.key.weight,
            attn.key.bias, attn.value.weight, attn.value.bias, attn.out.weight,
            attn.out.bias, norm.weight, norm.bias, key_mask,
            num_heads=attn.num_heads, eps=LN_EPS)
    res = dropout(_stock_attention(x, kv, attn, key_mask, dtype, dropout))
    return apply_add_layernorm(x, res, norm, dtype, gates.ln, dropout.training)


def feed_forward(x, linear1: Projection, linear2: Projection, norm: nn.LayerNorm,
                 dtype, dropout: Dropout, gates: Gates):
    """LayerNorm(x + Dropout(linear2(Dropout(relu(linear1(x))))))."""
    d, f = linear1.weight.shape
    if (not dropout.training and d % 128 == 0 and f % 128 == 0
            and fused_ffn_enabled(d, gates.ffn)):
        return ffn_addln(x.contiguous(), linear1.weight, linear1.bias, linear2.weight,
                         linear2.bias, norm.weight, norm.bias, eps=LN_EPS)
    h = dropout(torch.relu(linear1(x, dtype)))
    return apply_add_layernorm(x, dropout(linear2(h, dtype)), norm, dtype, gates.ln,
                               dropout.training)


class EncoderLayer(nn.Module):
    """Post-LN self-attention encoder layer (torch defaults); `gates`: the
    fused-block gates."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype=torch.float32, dropout_rate: float = 0.1, gates: Gates = Gates()):
        super().__init__()
        self.dtype = dtype
        self.gates = gates
        self.dropout = Dropout(dropout_rate)
        self.self_attn = MultiheadAttentionParams(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.linear1 = Projection(d_model, dim_feedforward)
        self.linear2 = Projection(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, mask=None):
        x = x.contiguous()
        x = attention_block(x, x, mask, self.self_attn, self.norm1, self.dtype,
                            self.dropout, self.gates)
        return feed_forward(x, self.linear1, self.linear2, self.norm2, self.dtype,
                            self.dropout, self.gates)


class DecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attn -> cross-attn -> feed-forward.

    `stage` factors the layer at the self/cross boundary (exact): "self"
    runs the self-attention block only, "rest" takes a tgt that already went
    through it. `gates`: the fused-block gates."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype=torch.float32, dropout_rate: float = 0.1, gates: Gates = Gates()):
        super().__init__()
        self.dtype = dtype
        self.gates = gates
        self.dropout = Dropout(dropout_rate)
        self.self_attn = MultiheadAttentionParams(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.cross_attn = MultiheadAttentionParams(d_model, num_heads)
        self.norm2 = nn.LayerNorm(d_model)
        self.linear1 = Projection(d_model, dim_feedforward)
        self.linear2 = Projection(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, memory=None, tgt_mask=None, memory_mask=None,
                stage: str = "full"):
        if stage not in ("full", "self", "rest"):
            raise ValueError(stage)
        tgt = tgt.contiguous()
        if stage != "rest":
            tgt = attention_block(tgt, tgt, tgt_mask, self.self_attn, self.norm1,
                                  self.dtype, self.dropout, self.gates)
            if stage == "self":
                return tgt
        tgt = attention_block(tgt, memory.contiguous(), memory_mask, self.cross_attn,
                              self.norm2, self.dtype, self.dropout, self.gates)
        return feed_forward(tgt, self.linear1, self.linear2, self.norm3, self.dtype,
                            self.dropout, self.gates)
