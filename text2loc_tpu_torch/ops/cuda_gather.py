"""Wrappers of the row gather and scatter-add kernels (csrc/gather_rows.cu)."""

from __future__ import annotations

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


def _word_bytes(row_bytes: int, *tensors) -> int:
    """The widest copy word (16, 8, 4 or 2 bytes) that divides a row and
    the tensors' addresses."""
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    raise ValueError(f"rows of {row_bytes} bytes: no 2-byte aligned copy word")


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
        word = _word_bytes(row_bytes, values, out)
        _cuda.launch(KERNEL, "t2l_gather_rows", _cuda.ptr(values), _cuda.ptr(idx),
                     _cuda.ptr(out), n, p, q, row_bytes // word, word)
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
