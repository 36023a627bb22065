"""Wrappers of the row gather and scatter-add kernels (csrc/gather_rows.cu),
and the gather's launch plan."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from text2loc_tpu_torch.ops import _cuda

_SOURCE = "text2loc_tpu_torch/csrc/gather_rows.cu"
KERNEL = _cuda.Kernel(
    name="gather_rows",
    source=_SOURCE,
    replaces="text2loc_tpu/ops/pallas_gather.py:35",
)
KERNEL_SCATTER = _cuda.Kernel(
    name="gather_rows_scatter",
    source=_SOURCE,
    replaces="text2loc_tpu/ops/pallas_gather.py:139",
)


def _check_idx(idx, n: int):
    if idx.ndim != 2 or idx.shape[0] != n:
        raise ValueError(f"idx {tuple(idx.shape)}: expected [{n}, Q]")
    _cuda.check(idx, "idx", dtype=torch.int32)


THREADS = 256                   # csrc/gather_rows.cu kThreads
MIN_CHUNK = 16 * THREADS        # output bytes a block: one 16-byte segment a thread
MAX_CHUNK = 64 * MIN_CHUNK
BLOCKS_PER_SM = 4               # the least blocks a plan asks for, per SM


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


@dataclass(frozen=True)
class GatherPlan:
    """word: bytes a copy step; chunk_bytes: output bytes a block of the
    staged variant (a multiple of 16), 0 for the direct variant (one warp a
    row); chunks: blocks a cloud (staged); smem: shared memory bytes of one
    staged block (t2l_gather_rows_smem)."""

    word: int
    chunk_bytes: int
    chunks: int
    smem: int


def staged_smem(p: int, row_bytes: int, chunk_bytes: int) -> int:
    """Shared memory of one staged block (csrc/gather_rows.cu staged_smem):
    the cloud's block from the 16-byte boundary below it, a zero row, and a
    source offset per output row the chunk touches, plus one."""
    slots = (chunk_bytes + 16) // row_bytes + 3
    return _align16(p * row_bytes) + 16 + _align16(row_bytes) + _align16(4 * slots)


@functools.lru_cache(maxsize=256)
def gather_plan(n: int, p: int, q: int, row_bytes: int, align: int = 16,
                sms: int = 132) -> GatherPlan:
    """The launch of a gather of q rows of row_bytes bytes from each of n
    clouds of p rows. word: the widest of 16, 8, 4 and 2 bytes that divides
    the row and `align` (the values' address alignment). Staged where the
    cloud's block fits one block's shared memory: a chunk of about 4 x the
    staged bytes (the staging read from L2 stays a quarter of the output),
    at least MIN_CHUNK and at most MAX_CHUNK, halved while the grid has
    fewer than BLOCKS_PER_SM blocks per SM; MIN_CHUNK where a larger chunk's
    offsets do not fit beside the cloud. Direct otherwise."""
    word = next((w for w in (16, 8, 4, 2) if row_bytes % w == 0 and align % w == 0), None)
    if word is None:
        raise ValueError(f"rows of {row_bytes} bytes at alignment {align}: no 2-byte copy word")
    out = q * row_bytes
    cb = min(max(_align16(4 * (_align16(p * row_bytes) + 16)), MIN_CHUNK), MAX_CHUNK,
             max(_align16(out), MIN_CHUNK))
    while cb > MIN_CHUNK and n * -(-out // cb) < BLOCKS_PER_SM * sms:
        cb = max(MIN_CHUNK, _align16(cb // 2))
    for chunk in (cb, MIN_CHUNK):
        smem = staged_smem(p, row_bytes, chunk)
        if smem <= _cuda.SMEM_LIMIT:
            return GatherPlan(word, chunk, max(1, -(-out // chunk)), smem)
    return GatherPlan(word, 0, 0, 0)


def gather_rows_cuda(values, idx):
    """values [N, P, C] (f32 or bf16), idx [N, Q] int32 -> [N, Q, C],
    bit-equal to torch.gather; an index outside [0, P) gives a zero row."""
    if values.dtype not in _cuda.DTYPE_CODE or values.ndim != 3:
        raise ValueError(f"values: expected [N, P, C] f32 or bf16, got "
                         f"{values.dtype} {tuple(values.shape)}")
    _cuda.check(values, "values")
    n, p, c = values.shape
    _check_idx(idx, n)
    q = idx.shape[1]
    out = torch.empty((n, q, c), dtype=values.dtype, device=values.device)
    if out.numel():
        row_bytes = c * values.element_size()
        addr = values.data_ptr()
        plan = gather_plan(n, p, q, row_bytes, 16 if addr % 16 == 0 else addr & -addr,
                           _cuda.sm_count(values.device.index))
        _cuda.launch(KERNEL, "t2l_gather_rows", _cuda.ptr(values), _cuda.ptr(idx),
                     _cuda.ptr(out), n, p, q, row_bytes, plan.word, plan.chunk_bytes,
                     plan.chunks)
    return out


def scatter_rows_cuda(g, idx, p: int):
    """g [N, Q, C] (f32 or bf16), idx [N, Q] int32 -> [N, P, C] in g's
    dtype: row p sums the rows of g whose index is p, in increasing q, in
    f32 (deterministic, no float atomics)."""
    if g.dtype not in _cuda.DTYPE_CODE or g.ndim != 3:
        raise ValueError(f"g: expected [N, Q, C] f32 or bf16, got {g.dtype} "
                         f"{tuple(g.shape)}")
    _cuda.check(g, "g")
    n, q, c = g.shape
    _check_idx(idx, n)
    if idx.shape[1] != q:
        raise ValueError(f"idx {tuple(idx.shape)} does not match g {tuple(g.shape)}")
    lib = _cuda.library()
    smem = lib.t2l_scatter_rows_smem(p, q)
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"scatter of Q={q} rows onto P={p} points needs {smem} B "
                         "of shared memory")
    out = torch.empty((n, p, c), dtype=g.dtype, device=g.device)
    if out.numel():
        if q == 0:
            return out.zero_()
        _cuda.launch(KERNEL_SCATTER, "t2l_scatter_rows", _cuda.ptr(g), _cuda.ptr(idx),
                     _cuda.ptr(out), n, p, q, c, _cuda.DTYPE_CODE[g.dtype])
    return out
