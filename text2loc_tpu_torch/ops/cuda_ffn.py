"""Wrappers of the feed-forward block's two CUDA kernels: the fused block to
d=256 (csrc/ffn_addln.cu: tiles of rows, each on one CUDA block or with the
hidden split over a cluster of blocks, as fused_plan says); the tiled chain
over all rows (csrc/ffn_tiled.cu: two products on wgmma fed by TMA
(csrc/gemm_wgmma.cuh), in bf16 on the weights as given, in f32 as 3xTF32
on their transposed split (csrc/tf32_split.cu, which the chain's entry
launches first), then the row LayerNorm of csrc/layernorm_rows.cuh) above it
and wherever the fused block's one-block layout does not fit in shared
memory. `route` picks one; there is no fallback."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from text2loc_tpu_torch.ops import _cuda, cuda_ln, cuda_split

KERNEL = _cuda.Kernel(
    name="ffn_addln",
    source="text2loc_tpu_torch/csrc/ffn_addln.cu",
    replaces="text2loc_tpu/ops/pallas_ffn.py:47",
)
KERNEL_TILED = _cuda.Kernel(
    name="ffn_addln_tiled",
    source="text2loc_tpu_torch/csrc/ffn_tiled.cu",
    replaces="text2loc_tpu/ops/pallas_ffn.py:47",
)

# The fused block's limits (checked() in csrc/ffn_addln.cu, which refuses a
# plan past them). The plan itself is fused_plan's alone: the launch passes
# its tile and cluster to the kernel.
FUSED_MAX_D = 256       # above it the tiled chain, whose GEMMs share the weights over all rows
FUSED_MAX_ROWS = 80     # rows of a tile: five m16 tiles
CLUSTERS = (16, 8, 4, 2)   # blocks a tile is split over, largest first (16: non-portable)
RING_BYTES = 3 * 16 * (4 * 64 + 4) * 4   # 3 weight chunks of 16 f32 rows of 256 columns


def _tsize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _align16(n: int) -> int:
    return (n + 15) & ~15


class FusedPlan(NamedTuple):
    rows: int       # rows of a tile (a multiple of 16, at most 80)
    cluster: int    # blocks of a tile: F split into `cluster` slices
    blocks: int     # CUDA blocks of the call: tiles x cluster
    smem: int       # dynamic shared bytes per block


def fused_smem(d: int, f: int, dtype, rows: int = 16, cluster: int = 1) -> int:
    """layout() of csrc/ffn_addln.cu for tiles of `rows` rows on clusters of
    `cluster` blocks, F / cluster hidden and D / cluster output columns a
    block: the x rows and the hidden slice in the dtype (rows padded by 16
    bytes); the f32 rows of the block's output columns from each block of
    the cluster (padded by 4 floats); two f32 row statistics from each
    block; the ring of weight chunks."""
    t = _tsize(dtype)
    pad = 8 if t == 2 else 4
    return (_align16(t * rows * (d + pad)) + _align16(t * rows * (f // cluster + pad))
            + _align16(4 * cluster * rows * (d // cluster + 4)) + _align16(8 * cluster * rows)
            + RING_BYTES)


@functools.lru_cache(maxsize=None)
def route(d: int, f: int, dtype) -> str:
    """"fused" where d <= 256, D and F are multiples of 16 and one block of
    a 16-row tile (the plan fused_plan falls back to last) fits a block's
    shared memory, else "tiled"."""
    if (16 <= d <= FUSED_MAX_D and d % 16 == 0 and f >= 16 and f % 16 == 0
            and fused_smem(d, f, dtype) <= _cuda.SMEM_LIMIT):
        return "fused"
    return "tiled"


@functools.lru_cache(maxsize=4096)
def fused_plan(rows: int, d: int, f: int, dtype, *, sms: int) -> Optional[FusedPlan]:
    """The fused block's plan of a call of `rows` rows on a card of `sms`
    SMs, or None where `route` does not send the shape to it. The first
    cluster size C of CLUSTERS that splits F into multiples of 16 and D into
    multiples of 8, whose tiles of C blocks fit one wave of the SMs with a
    tile of at most 80 rows (the fewest rows that do), lowered by 16 while
    the layout does not fit shared memory, and still one wave; C = 16, a
    non-portable cluster size, only where the rows fit one tile (the one
    case the H100 ran faster on 16 blocks than on 8). Else tiles of
    ceil(rows / sms) rows (one wave), at least 16 and at most 80, on the
    fewest blocks C of 1, 2, 4, 8 whose layout takes them (f32 at D=128,
    F=512 needs 2 for 80 rows); else C = 1, the tile lowered until the
    layout fits. A 16-row tile of C = 1 fits wherever route says "fused",
    so such a shape has a plan at every row count."""
    if route(d, f, dtype) != "fused":
        return None

    def plan(tile, c):
        return FusedPlan(tile, c, -(-rows // tile) * c, fused_smem(d, f, dtype, tile, c))

    def splits(c):
        return f % (16 * c) == 0 and d % (8 * c) == 0

    for c in CLUSTERS:
        if not splits(c) or c > sms or (c == 16 and rows > 16):
            continue
        tile = max(16, _align16(-(-rows // (sms // c))))
        while 16 < tile <= FUSED_MAX_ROWS and fused_smem(d, f, dtype, tile, c) > _cuda.SMEM_LIMIT:
            tile -= 16
        p = plan(tile, c)
        if tile <= FUSED_MAX_ROWS and p.smem <= _cuda.SMEM_LIMIT and p.blocks <= sms:
            return p
    tile = min(FUSED_MAX_ROWS, max(16, _align16(-(-rows // sms))))
    for c in (1, 2, 4, 8):
        if splits(c) and fused_smem(d, f, dtype, tile, c) <= _cuda.SMEM_LIMIT:
            return plan(tile, c)
    while fused_smem(d, f, dtype, tile, 1) > _cuda.SMEM_LIMIT:
        tile -= 16
    return plan(tile, 1)


def check_tiled(d: int, f: int, dtype) -> None:
    """Raise ValueError where the tiled chain cannot take the shape: D and
    F multiples of 128 (the GEMM tiles; the TPU kernel asserts the same),
    D within the last stage's row LayerNorm in `dtype`
    (cuda_ln.check_width: D <= 8192 in f32, 16384 in bf16)."""
    if d % 128 or f % 128:
        raise ValueError(f"the tiled feed-forward block takes D and F multiples of 128, "
                         f"not D={d}, F={f}")
    cuda_ln.check_width(d, dtype)


def _operands(x, w1, b1, w2, b2, scale, bias):
    """The tiled chain's operands: the weights in x.dtype and the vectors in
    f32, contiguous (each read as given where it already is so; a cast
    otherwise, as f32 weights under bf16 activations take), checked against
    x [..., D] and w1 [D, F]."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], w1.shape[1]
    w1_, w2_ = _cuda.as_given(w1, dt), _cuda.as_given(w2, dt)
    b1_, b2_, g_, be_ = (_cuda.as_given(t, torch.float32) for t in (b1, b2, scale, bias))
    _cuda.check(w1_, "w1", shape=(d, f))
    _cuda.check(w2_, "w2", shape=(f, d))
    _cuda.check(b1_, "b1", shape=(f,))
    for name, t in (("b2", b2_), ("scale", g_), ("bias", be_)):
        _cuda.check(t, name, shape=(d,))
    return w1_, b1_, w2_, b2_, g_, be_


def ffn_addln_cuda(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as ffn_addln_plain's. The fused
    kernel or the tiled chain, by `route`; in f32 the chain's entry first
    writes the split of W1 and W2 (a launch of cuda_split.KERNEL, counted
    here) into scratch."""
    d, f = x.shape[-1], w1.shape[1]
    if route(d, f, x.dtype) == "fused":
        return fused_block_cuda(x, w1, b1, w2, b2, scale, bias, eps)
    check_tiled(d, f, x.dtype)
    w1_, b1_, w2_, b2_, g_, be_ = _operands(x, w1, b1, w2, b2, scale, bias)
    rows = x.numel() // d
    # Scratch: the hidden [rows, F] in the dtype (208 MB in bf16 at the
    # intra stack's 25,344 rows), the pre-norm rows [rows, D] in f32.
    h = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    s2 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    f32 = x.dtype == torch.float32
    # f32: the split of W1 and W2 (W1^T [F, D], then W2^T [D, F]), hi and lo.
    wt = torch.empty((2, 2 * d * f), dtype=x.dtype, device=x.device) if f32 else None
    if rows:
        _cuda.launch(KERNEL_TILED, "t2l_ffn_addln_tiled",
                     *(_cuda.ptr(t) for t in (x, w1_, b1_, w2_, b2_)),
                     *(cuda_split.halves(wt) if f32 else (None, None)),
                     *(_cuda.ptr(t) for t in (g_, be_, out, h, s2)), rows, d, f,
                     ctypes.c_float(eps), _cuda.DTYPE_CODE[x.dtype])
        if f32:
            cuda_split.KERNEL.launches += 1
    return out


def fused_block_cuda(x, w1, b1, w2, b2, scale, bias, eps: float = 1e-5, *, out=None,
                     count: bool = True):
    """One launch of the fused kernel (csrc/ffn_addln.cu) with fused_plan's
    tile and cluster for this card, for a shape that `route` sends to it
    (ValueError for any other): w1 [D, F] and w2 [F, D] read as given where
    both are f32 or both x.dtype (rounded to x.dtype in the kernel), b1 [F],
    b2, scale and bias [D] f32. On the model's tensors (contiguous, f32
    parameters) this issues the kernel and no other device op. `out`: x's
    shape and dtype, allocated where None. `count=False`: a launch that is
    not the main path's (a probe timing the kernel alone)."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], w1.shape[1]
    wdt = torch.float32 if w1.dtype == w2.dtype == torch.float32 else dt
    w1, w2 = _cuda.as_given(w1, wdt), _cuda.as_given(w2, wdt)
    b1, b2, scale, bias = (_cuda.as_given(t, torch.float32) for t in (b1, b2, scale, bias))
    out = torch.empty_like(x) if out is None else out
    # x passed the full check; the others need only x's device, their shapes
    # and contiguity (as_given and empty_like give contiguous tensors).
    index = x.get_device()
    for name, t, shape in (("w1", w1, (d, f)), ("w2", w2, (f, d)), ("b1", b1, (f,)),
                           ("b2", b2, (d,)), ("scale", scale, (d,)), ("bias", bias, (d,)),
                           ("out", out, x.shape)):
        if t.get_device() != index or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, expected a contiguous "
                             f"{tuple(shape)} on {x.device}")
    if out.dtype != dt:
        raise ValueError(f"out: dtype {out.dtype}, expected {dt}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the fused kernel loads 16-byte vectors; the data "
                             "must start on a 16-byte boundary")
    rows = x.numel() // d
    plan = fused_plan(rows, d, f, dt, sms=_cuda.sm_count(index))
    if plan is None:
        raise ValueError(
            f"the fused feed-forward block takes D <= {FUSED_MAX_D}, multiples of 16, whose "
            f"16-row tile fits a block's shared memory: D={d}, F={f}, {dt} needs "
            f"{fused_smem(d, f, dt)} B; the limit is {_cuda.SMEM_LIMIT} B")
    if rows:
        _cuda.launch(KERNEL, "t2l_ffn_addln", *(_cuda.ptr(t) for t in (
            x, w1, b1, w2, b2, scale, bias, out)), rows, d, f, ctypes.c_float(eps),
            _cuda.DTYPE_CODE[dt], _cuda.DTYPE_CODE[wdt], plan.rows, plan.cluster, count=count)
    return out


# The tiled chain's stages launched one at a time, each to be held against
# its plain stage (ops/ffn.py), through the C entries that run the block's
# own functions. The main path never calls these, and they do not count as
# launches of the block.


def tiled_hidden_cuda(x, w1, b1, *, split=None):
    """Stage (a): round(relu(x W1 + b1)) [..., F] in x.dtype, as
    ffn_hidden_plain; in f32 on W1's split, `split` (cuda_split's (hi, lo)
    of W1) or made here, launched uncounted."""
    dt = x.dtype
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], w1.shape[1]
    check_tiled(d, f, x.dtype)
    w1_, b1_ = _cuda.as_given(w1, dt), _cuda.as_given(b1, torch.float32)
    _cuda.check(w1_, "w1", shape=(d, f))
    _cuda.check(b1_, "b1", shape=(f,))
    h = torch.empty((*x.shape[:-1], f), dtype=dt, device=x.device)
    wt, _keep = cuda_split.stage_args((w1_,), dt, split=split)
    _cuda.launch(KERNEL_TILED, "t2l_ffn_tiled_gemm_relu", _cuda.ptr(x), _cuda.ptr(w1_), *wt,
                 _cuda.ptr(b1_), _cuda.ptr(h), x.numel() // d, d, f, _cuda.DTYPE_CODE[dt],
                 count=False)
    return h


def tiled_out_addln_cuda(x, h, w2, b2, scale, bias, eps: float = 1e-5, *, split=None):
    """Stages (b) and (c): LayerNorm((f32(x) + h W2) + b2) [..., D] in
    x.dtype, as ffn_out_addln_plain; x [..., D], h [..., F], w2 [F, D]; in
    f32 on W2's split, `split` or made here, launched uncounted."""
    dt = x.dtype
    _cuda.check(x, "x", dtype=dt)
    d, f = x.shape[-1], h.shape[-1]
    check_tiled(d, f, x.dtype)
    _cuda.check(h, "h", dtype=dt, shape=(*x.shape[:-1], f))
    w2_ = _cuda.as_given(w2, dt)
    b2_, g_, be_ = (_cuda.as_given(t, torch.float32) for t in (b2, scale, bias))
    _cuda.check(w2_, "w2", shape=(f, d))
    for name, t in (("b2", b2_), ("scale", g_), ("bias", be_)):
        _cuda.check(t, name, shape=(d,))
    rows = x.numel() // d
    s2 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    if rows:
        wt, _keep = cuda_split.stage_args((w2_,), dt, split=split)
        _cuda.launch(KERNEL_TILED, "t2l_ffn_tiled_out_addln", _cuda.ptr(x), _cuda.ptr(h),
                     _cuda.ptr(w2_), *wt, *(_cuda.ptr(t) for t in (b2_, g_, be_, out, s2)),
                     rows, d, f, ctypes.c_float(eps), _cuda.DTYPE_CODE[dt], count=False)
    return out
