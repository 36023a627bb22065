"""Wrapper of the fused residual add + LayerNorm kernel (csrc/add_ln.cu, the
row routine of csrc/layernorm_rows.cuh), and the plan of that routine."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="add_ln",
    source="text2loc_tpu_torch/csrc/add_ln.cu",
    replaces="text2loc_tpu/ops/pallas_ln.py:36",
)
WIDTHS = (128, 256, 512, 1024)   # the add+LayerNorm block's row widths

# The row routine's limits (layout() in csrc/layernorm_rows.cuh, which
# refuses a width past them): blocks of WARPS warps; a row of 16 chunks of
# 16 bytes is a half-warp's, a wider one a warp's with up to MAX_CHUNKS
# chunks a lane.
WARPS = 8
MAX_CHUNKS = 8


class RowPlan(NamedTuple):
    lanes: int           # lanes of a row: 16 or 32
    chunks: int          # 16-byte chunks a lane: 1, 2, 4 or 8
    rows_per_warp: int   # rows a warp takes at a time: 32 / lanes
    blocks: int          # blocks of the call: the rows once, at most per_sm a SM
    per_sm: int          # resident blocks per SM the kernel's launch bounds ask for


def _blocks_per_sm(chunks: int, v: int) -> int:
    """blocks_per_sm of csrc/layernorm_rows.cuh: by the chunks a lane loads
    and the f32 values it keeps of its row (v a chunk)."""
    values = chunks * v
    if values <= 16:
        return 6 if values <= 8 else 5
    return (4 if chunks <= 4 else 3) if values <= 32 else 2


@functools.lru_cache(maxsize=4096)
def row_plan(rows: int, d: int, dtype, *, sms: int) -> RowPlan:
    """The row routine's plan for `rows` rows of width `d` in `dtype` on a
    card of `sms` SMs: d in 16-byte chunks of the dtype (8 bf16 or 4 f32
    values), 16 to 256 of them (ValueError otherwise); 16 chunks (D=128 in
    bf16) a half-warp's, two rows a warp; more a whole warp's, the fewest
    chunks a lane of 1, 2, 4, 8 that cover the row; blocks enough for every
    row once, at most per_sm blocks on each SM (the warps then walk the
    rows in a grid-stride loop)."""
    v = 16 // (2 if dtype == torch.bfloat16 else 4)
    n = d // v
    if d <= 0 or d % v or not 16 <= n <= 32 * MAX_CHUNKS:
        raise ValueError(f"the row LayerNorm takes widths of 16 to {32 * MAX_CHUNKS} "
                         f"16-byte chunks: D={d} in {dtype}")
    lanes = 16 if n == 16 else 32
    chunks = 1
    while lanes * chunks < n:
        chunks *= 2
    per_sm = _blocks_per_sm(chunks, v)
    rows_per_warp = 32 // lanes
    need = -(-rows // (WARPS * rows_per_warp))
    return RowPlan(lanes, chunks, rows_per_warp, min(need, sms * per_sm), per_sm)


def add_layernorm_cuda(x, res, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as add_layernorm_plain's. The
    kernel reads x, res, scale and bias in 16-byte vectors: their data must
    start on a 16-byte boundary (ValueError otherwise); scale and bias are
    read as given where f32 and contiguous."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    d = x.shape[-1]
    if d not in WIDTHS:
        raise ValueError(f"add+LayerNorm kernel: width {d} not in {WIDTHS}")
    _cuda.check(x, "x", dtype=dt)
    _cuda.check(res, "res", dtype=dt, shape=x.shape)
    g_, b_ = _cuda.as_given(scale, torch.float32), _cuda.as_given(bias, torch.float32)
    _cuda.check(g_, "scale", shape=(d,))
    _cuda.check(b_, "bias", shape=(d,))
    out = torch.empty_like(x)
    for name, t in (("x", x), ("res", res), ("scale", g_), ("bias", b_)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the add+LayerNorm kernel loads 16-byte vectors; the "
                             "data must start on a 16-byte boundary")
    rows = x.numel() // d
    if rows:
        plan = row_plan(rows, d, dt, sms=_cuda.sm_count(x.get_device()))
        _cuda.launch(KERNEL, "t2l_add_ln",
                     *(_cuda.ptr(t) for t in (x, res, g_, b_, out)),
                     rows, d, ctypes.c_float(eps), plan.rows_per_warp, plan.blocks,
                     _cuda.DTYPE_CODE[dt])
    return out
