"""The transposed TF32 split of the tiled chains' f32 weights
(csrc/tf32_split.cu): for each weight W [K, N] ([in, out], as the model
holds it) hi = tf32_rna(W^T) and lo = tf32_rna(W^T - hi), both [N, K]
f32, the operands of the chains' 3xTF32 products (csrc/gemm_wgmma.cuh),
which take B K-major only. Written per call from the weights as the caller
holds them: no cache, the weights themselves never rounded. The kernel's
plain version is split_t_plain, which it equals bit for bit."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="tf32_split",
    source="text2loc_tpu_torch/csrc/tf32_split.cu",
    # The first stage of the tiled chains that port the attention and the
    # feed-forward TPU kernels (pallas_ffn.py:47 too); none of its own.
    replaces="text2loc_tpu/ops/pallas_mha.py:137",
)
MAX_MATS = 4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits, ties away from zero), as
    the kernels round it (t2l::tf32_rna, csrc/common.cuh): two integer
    operations on the bits, cvt.rna.tf32.f32 on finite values."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split_t_plain(mats) -> tuple:
    """(hi, lo), flat f32: for each W_j [K_j, N_j] of `mats` the split of
    W_j^T [N_j, K_j] (row-major), one weight after another, as the kernel
    writes them."""
    hi, lo = [], []
    for w in mats:
        wt = w.float().t().contiguous()
        h = tf32_rna(wt)
        hi.append(h.reshape(-1))
        lo.append(tf32_rna(wt - h).reshape(-1))
    return torch.cat(hi), torch.cat(lo)


def split_t_cuda(mats) -> tuple:
    """split_t_plain by the kernel, alone: `mats` 1 to 4 contiguous f32
    [K_j, N_j] CUDA tensors, read as given. For the tests, the probes and
    the chains' stage entries; the launch is not counted (the main path's
    launches are the chains' whole-block entries', which launch the kernel
    themselves and count it)."""
    if not 1 <= len(mats) <= MAX_MATS:
        raise ValueError(f"the split takes 1 to {MAX_MATS} weights, not {len(mats)}")
    for i, w in enumerate(mats):
        _cuda.check(w, f"w{i}", dtype=torch.float32)
        if w.ndim != 2:
            raise ValueError(f"w{i}: expected [K, N], got {tuple(w.shape)}")
    total = sum(w.numel() for w in mats)
    dev = mats[0].device
    hi = torch.empty(total, dtype=torch.float32, device=dev)
    lo = torch.empty(total, dtype=torch.float32, device=dev)
    args = []
    for j in range(MAX_MATS):
        if j < len(mats):
            args += [_cuda.ptr(mats[j]), mats[j].shape[0], mats[j].shape[1]]
        else:
            args += [None, 0, 0]
    if total:
        _cuda.launch(KERNEL, "t2l_tf32_split_t", *args, len(mats), _cuda.ptr(hi), _cuda.ptr(lo),
                     count=False)
    return hi, lo


def halves(wt: torch.Tensor) -> tuple:
    """The (hi, lo) pointers of a [2, n] f32 scratch for a split: the chains'
    whole-block entries write the split there themselves."""
    return _cuda.ptr(wt), ctypes.c_void_p(wt.data_ptr() + 4 * wt.shape[1])


def stage_args(mats, dtype, *, split=None) -> tuple:
    """The split arguments of a tiled chain's stage entry: where `dtype` is
    f32, the (hi, lo) pointers of the weights' split (`split`, made
    beforehand and checked against the weights' sizes, or split_t_cuda's),
    else two NULLs; and the split tensors, to keep alive over the launch
    that reads them."""
    if dtype != torch.float32:
        return (None, None), ()
    if split is None:
        split = split_t_cuda(mats)
    total = sum(w.numel() for w in mats)
    for name, t in zip(("hi", "lo"), split):
        _cuda.check(t, name, dtype=torch.float32, shape=(total,))
    return (_cuda.ptr(split[0]), _cuda.ptr(split[1])), split
