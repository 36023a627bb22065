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
# The row routine's limits (layout() in csrc/layernorm_rows.cuh, which
# refuses a width past them): blocks of WARPS warps; a row of 16 chunks of
# 16 bytes is a half-warp's, a wider one a warp's with up to MAX_CHUNKS
# chunks a lane, and a row past a warp's chunks (the wide layout) is spread
# over 2, 4 or WARPS warps with MAX_CHUNKS chunks a lane: at most
# WARPS x 32 x MAX_CHUNKS = 2048 chunks, D = 8192 in f32 and 16384 in bf16.
WARPS = 8
MAX_CHUNKS = 8
MAX_ROW_CHUNKS = WARPS * 32 * MAX_CHUNKS


class RowPlan(NamedTuple):
    lanes: int           # lanes of a row in a warp: 16 or 32
    chunks: int          # 16-byte chunks a lane: 1, 2, 4 or 8
    rows_per_warp: int   # 32 / lanes: 2 where a half-warp owns a row, else 1
    blocks: int          # blocks of the call: the rows once, at most per_sm a SM
    per_sm: int          # resident blocks per SM the kernel's launch bounds ask for
    warps: int           # warps of a row: 1, or 2, 4 or 8 in the wide layout


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
    card of `sms` SMs, and its one check of the width: d in 16-byte chunks
    of the dtype (8 bf16 or 4 f32 values), 16 to MAX_ROW_CHUNKS of them
    (ValueError otherwise, before any launch). 16 chunks (D=128 in bf16)
    are a half-warp's, two rows a warp; up to 256 a whole warp's, the
    fewest chunks a lane of 1, 2, 4, 8 that cover the row; more are the
    wide layout's, the fewest warps of 2, 4, 8 that cover the row at 8
    chunks a lane, the block's warps taking WARPS / warps rows at a time.
    Blocks enough for every row once, at most per_sm on each SM (by the
    registers; past D = 14336 in bf16 one wide block's gamma and beta fill
    an SM's shared memory, and its second block waits), whose warps then
    walk the rows in a grid-stride loop."""
    v = 16 // (2 if dtype == torch.bfloat16 else 4)
    n = d // v
    if d <= 0 or d % v or not 16 <= n <= MAX_ROW_CHUNKS:
        raise ValueError(f"the row LayerNorm takes widths of 16 to {MAX_ROW_CHUNKS} "
                         f"16-byte chunks (D <= {MAX_ROW_CHUNKS * 4} in f32, "
                         f"{MAX_ROW_CHUNKS * 8} in bf16): D={d} in {dtype}")
    lanes = 16 if n == 16 else 32
    warps = 1
    while lanes * MAX_CHUNKS * warps < n:
        warps *= 2
    chunks = 1
    while lanes * chunks * warps < n:
        chunks *= 2
    per_sm = _blocks_per_sm(chunks, v)
    rows_per_warp = 32 // lanes
    need = -(-rows // (WARPS * rows_per_warp // warps))
    return RowPlan(lanes, chunks, rows_per_warp, min(need, sms * per_sm), per_sm, warps)


def check_width(d: int, dtype) -> None:
    """Raise ValueError where the row routine cannot take rows of width d
    in dtype (row_plan's check), for the callers that check a shape before
    any launch: add_layernorm_cuda and the tiled chains' check_tiled."""
    row_plan(1, d, dtype, sms=1)


def add_layernorm_cuda(x, res, scale, bias, eps: float = 1e-5):
    """[..., D] in x.dtype; the arguments as add_layernorm_plain's. D a
    multiple of 128, as the TPU kernel asks, within the row routine's
    limit (row_plan; ValueError otherwise). The kernel reads x, res, scale
    and bias in 16-byte vectors: their data must start on a 16-byte
    boundary (ValueError otherwise); scale and bias are read as given where
    f32 and contiguous."""
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"x: unsupported dtype {dt}")
    d = x.shape[-1]
    if d <= 0 or d % 128:
        raise ValueError(f"add+LayerNorm kernel: width {d} is not a multiple of 128")
    check_width(d, dt)
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
