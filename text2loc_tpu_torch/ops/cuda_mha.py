"""Wrappers of the attention block's two CUDA kernels: the fused block to
d=256 (csrc/mha_addln.cu: groups of samples, each on one CUDA block or on a
cluster of one block per head, as fused_plan says); the tiled chain over
all rows (csrc/mha_tiled.cu: wgmma products fed by TMA (csrc/gemm_wgmma.cuh),
in bf16 on the weights as given, in f32 as 3xTF32 on their transposed
split (csrc/tf32_split.cu, which the chain's entry launches first), a tensor-core
attention core planned by core_layout, a row LayerNorm) above it and
wherever the fused block does not take the shape. `route` picks one; there
is no fallback."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from text2loc_tpu_torch.ops import _cuda, cuda_ln, cuda_split

KERNEL = _cuda.Kernel(
    name="mha_addln",
    source="text2loc_tpu_torch/csrc/mha_addln.cu",
    replaces="text2loc_tpu/ops/pallas_mha.py:137",
)
KERNEL_TILED = _cuda.Kernel(
    name="mha_addln_tiled",
    source="text2loc_tpu_torch/csrc/mha_tiled.cu",
    replaces="text2loc_tpu/ops/pallas_mha.py:137",
)

# The fused block's limits (checked() in csrc/mha_addln.cu, which refuses a
# plan past them). The plan itself is fused_plan's alone: the launch passes
# its samples and cluster to the kernel.
FUSED_MAX_D = 256     # above it the tiled chain, whose GEMMs share the weights over all rows
FUSED_MAX_ROWS = 80   # query rows, and key rows, of one CUDA block
FUSED_MAX_KEYS = 32   # keys of a sample (four n8 score tiles)
FUSED_MAX_DH = 64     # head width (eight n8 output tiles)
FUSED_MAX_HEADS = 8   # a cluster of one block per head: the portable cluster size
RING_BYTES = 3 * 16 * (3 * FUSED_MAX_DH + 4) * 4   # 3 weight chunks of 16 f32 rows


def _tsize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _align16(n: int) -> int:
    return (n + 15) & ~15


class FusedPlan(NamedTuple):
    samples: int    # samples per group (G)
    rows: int       # query rows per block, G * Lq padded to 16
    key_rows: int   # key rows per block (the query rows in self-attention)
    blocks: int     # groups, ceil(B / G): one cluster each
    cluster: int    # blocks per cluster: one per head, or 1
    smem: int       # dynamic shared bytes per block


def _fused_layout(g, c, lq, lk, d, self_attn, t) -> FusedPlan:
    """layout() of csrc/mha_addln.cu for G = g and a cluster of c blocks, w
    = d / c columns a block: x rows; in a cluster, every head's o; the
    block's q (with c = 1 first the kv rows of cross-attention), k, v; the
    f32 pre-norm rows of its columns over the k, v region; two f32 row
    statistics; the ring of weight chunks. Rows in the dtype, padded by 16
    bytes."""
    rows = _align16(g * lq)
    krows = rows if self_attn else _align16(g * lk)
    pad = 8 if t == 2 else 4
    w = d // c
    ldx, ldw = d + pad, w + pad
    orows = max(rows, krows)
    kbytes = _align16(t * krows * ldw)
    smem = (_align16(t * rows * ldx) + (_align16(t * orows * ldx) if c > 1 else 0)
            + _align16(t * (rows if c > 1 else orows) * ldw)
            + max(2 * kbytes, _align16(4 * rows * (w + 4))) + _align16(8 * rows) + RING_BYTES)
    return FusedPlan(g, rows, krows, 0, c, smem)


def route(lq: int, lk: int, d: int, heads: int, dtype, *, self_attn: bool = False) -> str:
    """"fused" where the fused block takes the shape at every B: within its
    limits (d <= 256, at most 8 heads, dh a multiple of 16 up to 64, Lq <=
    80, Lk <= 32), with one block of one sample, the plan fused_plan falls
    back to last, within a block's shared memory; else "tiled". Without
    `self_attn` the cross layout is assumed."""
    dh = d // heads if heads >= 1 else 0
    if (lq < 1 or lk < 1 or lq > FUSED_MAX_ROWS or lk > FUSED_MAX_KEYS or d < 32
            or d > FUSED_MAX_D or heads < 1 or heads > FUSED_MAX_HEADS or d % heads
            or (self_attn and lq != lk) or dh % 16 or dh > FUSED_MAX_DH):
        return "tiled"
    one = _fused_layout(1, 1, lq, lk, d, self_attn, _tsize(dtype))
    return "fused" if one.smem <= _cuda.SMEM_LIMIT else "tiled"


def fused_plan(b: int, lq: int, lk: int, d: int, heads: int, dtype, *,
               self_attn: bool = False, sms: int) -> Optional[FusedPlan]:
    """The fused block's plan of a call on a card of `sms` SMs, or None
    where `route` does not send the shape to it: G = min(80 // max(Lq, Lk),
    ceil(B / sms)) samples a group (one wave of blocks), lowered until the
    layout fits a block's shared memory; at each G a cluster of one block
    per head where those blocks fit the SMs and their layout fits, else one
    block a group. One block of one sample fits wherever route says
    "fused", so such a shape has a plan at every B."""
    if route(lq, lk, d, heads, dtype, self_attn=self_attn) != "fused":
        return None
    t = _tsize(dtype)
    for g in range(min(FUSED_MAX_ROWS // max(lq, lk), max(1, -(-b // sms))), 0, -1):
        groups = -(-b // g)
        for c in ((heads, 1) if heads > 1 and groups * heads <= sms else (1,)):
            p = _fused_layout(g, c, lq, lk, d, self_attn, t)
            if p.smem <= _cuda.SMEM_LIMIT:
                return p._replace(blocks=groups)
    raise AssertionError("unreachable: route checked one block of one sample")


# The tiled chain's attention core (csrc/mha_tiled.cu): a block per (sample,
# head, tile of CORE_ROWS query rows), the keys in chunks of one of
# CORE_CHUNKS rows (the kernel's instantiations), up to CORE_COLS output
# columns a pass.
CORE_ROWS = 16
CORE_CHUNKS = (16, 32, 64)
CORE_COLS = 256


def _core_buffer(chunk: int, dh: int, dtype) -> int:
    """Shared bytes of one buffer of the core's block for key chunks of
    `chunk` rows at head width dh (layout() in csrc/mha_tiled.cu): q
    [16][dh'] and a chunk of k [chunk][dh'] over the head width padded to 16
    (dh'), a chunk of v [chunk][min(dh', 256)] over one pass's columns; rows
    padded (bf16 by 8 elements; f32 q and k by 4, v by 8)."""
    t = _tsize(dtype)
    dhp = -(-dh // 16) * 16
    ldqk = dhp + (8 if t == 2 else 4)
    ldv = min(dhp, CORE_COLS) + 8
    return (_align16(t * CORE_ROWS * ldqk) + _align16(t * chunk * ldqk)
            + _align16(t * chunk * ldv))


def core_smem(chunk: int, sweeps: int, dh: int, dtype) -> int:
    """Shared bytes of the core's block (smem() in csrc/mha_tiled.cu): two
    buffers where the block pipelines its items (one sweep, a head of at
    most CORE_COLS columns, both buffers within a block's shared memory:
    the next item's q, k, v land while this one's are used), else one. It
    does not grow with Lq or Lk."""
    one = _core_buffer(chunk, dh, dtype)
    piped = sweeps == 1 and -(-dh // 16) * 16 <= CORE_COLS and 2 * one <= _cuda.SMEM_LIMIT
    return 2 * one if piped else one


class CoreLayout(NamedTuple):
    """The attention core's plan."""

    rows: int       # query rows of a block (one m16 tile)
    chunk: int      # keys of a chunk
    sweeps: int     # 1: a chunk holds every key; 2: running max and sum, then p and P V
    smem: int       # dynamic shared bytes per block


def core_layout(lq: int, lk: int, d: int, heads: int, dtype) -> Optional[CoreLayout]:
    """The attention core's plan, passed to the kernel as (rows, chunk,
    sweeps), which only checks it (t2l_mha_tiled_core_smem): the smallest
    chunk of CORE_CHUNKS that holds every key, in one sweep, else the
    largest chunk, in two; only chunks within a block's shared memory at
    the head's width count (a wide head takes a narrower one); None where
    not even the smallest fits (a head far wider than any model's). Every
    length has a plan: the shared memory does not grow with Lq or Lk."""
    dh = d // heads
    fits = [c for c in CORE_CHUNKS if _core_buffer(c, dh, dtype) <= _cuda.SMEM_LIMIT]
    if not fits:
        return None
    chunk = next((c for c in fits if c >= lk), fits[-1])
    sweeps = 1 if lk <= chunk else 2
    return CoreLayout(CORE_ROWS, chunk, sweeps, core_smem(chunk, sweeps, dh, dtype))


def check_tiled(lq: int, lk: int, d: int, heads: int, dtype) -> CoreLayout:
    """The attention core's plan of the tiled chain at this shape;
    ValueError where the chain cannot take it: D a multiple of 128 (the GEMM
    tiles; the TPU kernel asks the same) within the last stage's row
    LayerNorm (cuda_ln.check_width: D <= 8192 in f32, 16384 in bf16), and a
    head whose q rows and smallest key chunk fit a block's shared memory
    (any Lq and Lk: the core streams the keys)."""
    if d % 128:
        raise ValueError(f"the tiled attention block takes D a multiple of 128, not {d}")
    cuda_ln.check_width(d, dtype)
    layout = core_layout(lq, lk, d, heads, dtype)
    if layout is None:
        dh = d // heads
        raise ValueError(
            f"the attention core needs at least {_core_buffer(CORE_CHUNKS[0], dh, dtype)} B of "
            f"shared memory at dh={dh} ({dtype}); the limit is {_cuda.SMEM_LIMIT} B")
    return layout


def _check_block(x, kv, mats, vecs, num_heads):
    """Validate the block's operands; return (b, lq, lk, d)."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    if x.ndim != 3 or kv.ndim != 3:
        raise ValueError("x and kv must be [B, L, D]")
    b, lq, d = x.shape
    lk = kv.shape[1]
    if d % num_heads or tuple(kv.shape) != (b, lk, d):
        raise ValueError(f"x {tuple(x.shape)} / kv {tuple(kv.shape)} / "
                         f"heads {num_heads} do not fit")
    _cuda.check(x, "x", dtype=dt)
    if kv is not x:
        _cuda.check(kv, "kv", dtype=dt)
    # x passed the full check; the others need only x's device, their shapes
    # and contiguity (one device query a call: the check is on the host's
    # path before every launch).
    index = x.get_device()
    for names, ts, shape in ((("wq", "wk", "wv", "wo"), mats, (d, d)),
                             (("bq", "bk", "bv", "bo", "scale", "bias"), vecs, (d,))):
        for name, t in zip(names, ts):
            if t.get_device() != index or t.shape != shape or not t.is_contiguous():
                raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, expected a "
                                 f"contiguous {shape} on {x.device}")
    return b, lq, lk, d


def mha_addln_cuda(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, scale, bias,
                   key_mask=None, *, num_heads: int, eps: float = 1e-5):
    """[B, Lq, D] in x.dtype; the arguments as mha_addln_plain's. `kv is x`
    selects the self-attention layout (one copy of the rows, one
    projection pass). The fused kernel or the tiled chain, by `route`."""
    from text2loc_tpu_torch.ops.mha import key_bias

    dt = x.dtype
    self_attn = kv is x
    if x.ndim == 3 and kv.ndim == 3 and route(x.shape[1], kv.shape[1], x.shape[2], num_heads,
                                              dt, self_attn=self_attn) == "fused":
        out = torch.empty_like(x)
        launch_fused(x, kv, (wq, wk, wv, wo), (bq, bk, bv, bo, scale, bias), key_mask, out,
                     num_heads=num_heads, eps=eps)
        return out
    # The products read bf16 weights by TMA (the model's f32 weights cast,
    # nothing packed), f32 weights through their split.
    mats = [_cuda.as_given(t, dt) for t in (wq, wk, wv, wo)]
    vecs = [_cuda.as_given(t, torch.float32) for t in (bq, bk, bv, bo, scale, bias)]
    b, lq, lk, d = _check_block(x, kv, mats, vecs, num_heads)
    layout = check_tiled(lq, lk, d, num_heads, dt)
    kb = key_bias(key_mask, b, lk, x.device).contiguous()
    return _tiled_block(x, kv, kb, mats, vecs, num_heads, eps, self_attn, layout)


def launch_fused(x, kv, mats, vecs, key_mask, out, *, num_heads: int, eps: float = 1e-5,
                 count: bool = True) -> None:
    """One launch of t2l_mha_addln into `out` (x's shape and dtype) with
    fused_plan's groups and cluster for this card, for a shape that `route`
    sends to the fused block (ValueError for any other): mats (wq, wk, wv,
    wo) [D, D] read as given where all four are f32 or all x.dtype (rounded
    to x.dtype in the kernel), vecs (bq, bk, bv, bo, scale, bias) [D] f32,
    key_mask [B, Lk] bool or None. On the
    model's tensors (contiguous, f32 parameters, a bool mask) this issues
    the kernel and no other device op. `count=False`: a launch that is not
    the main path's (a probe timing the kernel alone)."""
    dt = x.dtype
    wdt = torch.float32 if all(t.dtype == torch.float32 for t in mats) else dt
    mats = [_cuda.as_given(t, wdt) for t in mats]
    vecs = [_cuda.as_given(t, torch.float32) for t in vecs]
    b, lq, lk, d = _check_block(x, kv, mats, vecs, num_heads)
    mask = None
    if key_mask is not None:
        mask = _cuda.as_given(key_mask, torch.bool)
        _cuda.check(mask, "key_mask", shape=(b, lk))
    _cuda.check(out, "out", dtype=dt, shape=tuple(x.shape))
    for name, t in (("x", x), ("kv", kv), ("wq", mats[0]), ("wk", mats[1]), ("wv", mats[2]),
                    ("wo", mats[3]), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the fused kernel loads 16-byte vectors; the data "
                             "must start on a 16-byte boundary")
    plan = fused_plan(b, lq, lk, d, num_heads, dt, self_attn=kv is x,
                      sms=_cuda.sm_count(x.get_device()))
    if plan is None:
        raise ValueError(f"the fused attention block does not take Lq={lq}, Lk={lk}, D={d}, "
                         f"{num_heads} heads, {dt}: route gives the tiled chain")
    if b == 0:
        return
    _cuda.launch(
        KERNEL, "t2l_mha_addln", _cuda.ptr(x), _cuda.ptr(kv),
        None if mask is None else _cuda.ptr(mask),
        *(_cuda.ptr(t) for t in (mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2],
                                 mats[3], vecs[3], vecs[4], vecs[5], out)),
        b, lq, lk, d, num_heads,
        ctypes.c_float(1.0 / math.sqrt(d // num_heads)), ctypes.c_float(eps),
        int(kv is x), _cuda.DTYPE_CODE[dt], _cuda.DTYPE_CODE[wdt], plan.samples, plan.cluster,
        count=count,
    )


def _tiled_block(x, kv, kb, mats, vecs, num_heads, eps, self_attn, layout):
    """One call of t2l_mha_addln_tiled: in f32 the split of the four
    weights (a launch of cuda_split.KERNEL, counted here), then the
    projection product(s), the core (of `layout`), the out-projection with
    the residual, the LayerNorm; the weights and biases passed as they are,
    one pointer each. Scratch from torch.empty: q/k/v and o in the dtype,
    the pre-norm rows in f32, in f32 the split [2, 4D, D]."""
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    m, mk = b * lq, b * lk
    wq, wk, wv, wo = mats
    bq, bk, bv, bo, g, be = vecs
    qkv = torch.empty(m * 3 * d if self_attn else m * d + mk * 2 * d, dtype=dt,
                      device=x.device)
    o = torch.empty((m, d), dtype=dt, device=x.device)
    s2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    f32 = dt == torch.float32
    wt = torch.empty((2, 4 * d * d), dtype=dt, device=x.device) if f32 else None
    if b:
        _cuda.launch(
            KERNEL_TILED, "t2l_mha_addln_tiled",
            *(_cuda.ptr(t) for t in (x, kv, kb, wq, wk, wv, bq, bk, bv, wo, bo)),
            *(cuda_split.halves(wt) if f32 else (None, None)),
            *(_cuda.ptr(t) for t in (g, be, out, qkv, o, s2)),
            b, lq, lk, d, num_heads, layout.rows, layout.chunk, layout.sweeps,
            ctypes.c_float(1.0 / math.sqrt(d // num_heads)), ctypes.c_float(eps),
            int(self_attn), _cuda.DTYPE_CODE[dt],
        )
        if f32:
            cuda_split.KERNEL.launches += 1
    return out


# The tiled chain's stages launched one at a time, each to be held against
# its plain stage (ops/mha.py). The main path never calls these, and they
# do not count as launches of the block.


def _gemm(a, w, bias, c, *, res=None, nscale=0, scale=1.0, split=None):
    """c = round((a w + bias) * colscale) (the first nscale columns scaled),
    or with `res` c (f32) = (f32(res) + a w) + bias. a [M, K], w [K, N], c
    [M, N] and res [M, N] contiguous; in f32 on w's split, `split` or made
    here, launched uncounted."""
    m, k = a.shape
    n = c.shape[1]
    wt, _keep = cuda_split.stage_args((w,), a.dtype, split=split)
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_gemm", _cuda.ptr(a), k, _cuda.ptr(w),
                 w.stride(0), *wt, _cuda.ptr(bias), _cuda.ptr(c), c.stride(0),
                 None if res is None else _cuda.ptr(res), n, m, n, k, nscale,
                 ctypes.c_float(scale), _cuda.DTYPE_CODE[a.dtype], count=False)


def tiled_project_cuda(x, kv, wq, bq, wk, bk, wv, bv, *, num_heads: int, split=None):
    """Stage (a): (q, k, v) as mha_project_plain returns them, by the
    projection product(s) of the main path (one over Wq, Wk, Wv side by side
    when `kv is x`, else x Wq and kv [Wk|Wv]); in f32 on the three weights'
    split, `split` (cuda_split's (hi, lo) of Wq, Wk, Wv) or made here,
    launched uncounted."""
    dt = x.dtype
    b, lq, d = x.shape
    lk = kv.shape[1]
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(kv, "kv", dtype=dt)
    mats = [_cuda.as_given(t, dt) for t in (wq, wk, wv)]
    vecs = [_cuda.as_given(t, torch.float32) for t in (bq, bk, bv)]
    for name, t in zip(("wq", "wk", "wv"), mats):
        _cuda.check(t, name, shape=(d, d))
    for name, t in zip(("bq", "bk", "bv"), vecs):
        _cuda.check(t, name, shape=(d,))
    self_attn = kv is x
    m, mk = b * lq, b * lk
    qkv = torch.empty(m * 3 * d if self_attn else m * d + mk * 2 * d, dtype=dt,
                      device=x.device)
    if b:
        wt, _keep = cuda_split.stage_args(mats, dt, split=split)
        _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_project", _cuda.ptr(x), _cuda.ptr(kv),
                     *(_cuda.ptr(t) for t in (*mats, *vecs)), *wt, _cuda.ptr(qkv), b, lq, lk, d,
                     ctypes.c_float(1.0 / math.sqrt(d // num_heads)), int(self_attn),
                     _cuda.DTYPE_CODE[dt], count=False)
    if self_attn:
        qkv = qkv.view(m, 3 * d)
        q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    else:
        q = qkv[:m * d].view(m, d)
        kvp = qkv[m * d:].view(mk, 2 * d)
        k, v = kvp[:, :d], kvp[:, d:]
    return q.reshape(b, lq, d), k.reshape(b, lk, d), v.reshape(b, lk, d)


def tiled_core_cuda(q, k, v, key_mask=None, *, num_heads: int):
    """Stage (b): the attention output o [B, Lq, D], as mha_core_plain."""
    from text2loc_tpu_torch.ops.mha import key_bias

    dt = q.dtype
    b, lq, d = q.shape
    lk = k.shape[1]
    layout = check_tiled(lq, lk, d, num_heads, dt)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.check(t, name, dtype=dt)
    kb = key_bias(key_mask, b, lk, q.device).contiguous()
    o = torch.empty_like(q)
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_core", _cuda.ptr(q), d, _cuda.ptr(k),
                 _cuda.ptr(v), d, _cuda.ptr(kb), _cuda.ptr(o), b, lq, lk, d, num_heads,
                 layout.rows, layout.chunk, layout.sweeps, _cuda.DTYPE_CODE[dt], count=False)
    return o


def tiled_out_addln_cuda(x, o, wo, bo, scale, bias, *, eps: float = 1e-5, split=None):
    """Stages (c) and (d): LayerNorm((f32(x) + o Wo) + bo) in x.dtype, as
    mha_out_addln_plain; x [..., D], o [..., K] and wo [K, D] (K = D in the
    block); in f32 on Wo's split, `split` or made here. The feed-forward
    chain's stages (b) and (c) have their own entry,
    cuda_ffn.tiled_out_addln_cuda."""
    dt = x.dtype
    d, k = x.shape[-1], o.shape[-1]
    m = x.numel() // d
    cuda_ln.check_width(d, dt)
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(o, "o", dtype=dt, shape=(*x.shape[:-1], k))
    wo_, bo_, g, be = (_cuda.as_given(wo, dt), *(_cuda.as_given(t, torch.float32)
                                                 for t in (bo, scale, bias)))
    _cuda.check(wo_, "wo", shape=(k, d))
    s2 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    _gemm(o.reshape(m, k), wo_, bo_, s2, res=x.reshape(m, d), split=split)
    out = torch.empty_like(x)
    _cuda.launch(KERNEL_TILED, "t2l_mha_tiled_ln", _cuda.ptr(s2), _cuda.ptr(g),
                 _cuda.ptr(be), _cuda.ptr(out), m, d, ctypes.c_float(eps),
                 _cuda.DTYPE_CODE[dt], count=False)
    return out
