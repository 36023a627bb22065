"""Wrappers of the inference SA kernel (csrc/sa_level.cuh): one template,
five neighbour selections, each built from its own source with its own C
entry point t2l_sa_level_<selection> and its own launch count."""

from __future__ import annotations

import ctypes

import torch

from text2loc_tpu_torch.ops import _cuda


def _kernel(name: str, source: str, replaces: str) -> _cuda.Kernel:
    return _cuda.Kernel(name, f"text2loc_tpu_torch/csrc/{source}",
                        f"text2loc_tpu/ops/pallas_pointconv.py:{replaces}")


KERNEL_FIRST = _kernel("sa_select_first", "sa_select.cu", "451")
KERNEL_BISECT = _kernel("sa_select_bisect", "sa_select_bisect.cu", "451")
KERNEL_GATHER = _kernel("sa_gather", "sa_gather.cu", "242")
KERNEL_EXACT = _kernel("sa_exact", "sa_exact.cu", "116")
KERNEL_ALL = _kernel("sa_all", "sa_all.cu", "116")
KERNELS = (KERNEL_FIRST, KERNEL_BISECT, KERNEL_GATHER, KERNEL_EXACT, KERNEL_ALL)
_KERNEL_OF = dict(zip(("first", "bisect", "gather", "exact", "all"), KERNELS))
MAX_K = 32         # neighbour slots per tile
MAX_P = 256        # points the register-resident selections hold (8 per lane)
_THREADS = 256


def _launch(sel: str, feat, pos, centers, nidx, nmask, w1, wp, ab1, w2, ab2,
            radius: float, k: int, iters: int = 0) -> torch.Tensor:
    """Check the arguments and launch selection `sel`: [N, S, H2] in
    feat.dtype."""
    dt = feat.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"feat: unsupported dtype {dt}")
    if feat.ndim != 3:
        raise ValueError(f"feat: expected [N, P, C], got {tuple(feat.shape)}")
    n, p, c = feat.shape
    s = centers.shape[1]
    h1, h2 = w1.shape[1], w2.shape[1]
    _cuda.check(feat, "feat", dtype=dt)
    if sel != "gather":
        _cuda.check(pos, "pos", dtype=torch.float32, shape=(n, p, 3))
    _cuda.check(centers, "centers", dtype=torch.float32, shape=(n, s, 3))
    _cuda.check(w1, "w1", dtype=dt, shape=(c, h1))
    _cuda.check(wp, "wp", dtype=dt, shape=(3, h1))
    _cuda.check(ab1, "ab1", dtype=torch.float32, shape=(2, h1))
    _cuda.check(w2, "w2", dtype=dt, shape=(h1, h2))
    _cuda.check(ab2, "ab2", dtype=torch.float32, shape=(2, h2))
    if sel == "gather":
        _cuda.check(nidx, "idx", dtype=torch.int32, shape=(n, s, k))
        _cuda.check(nmask, "mask", dtype=torch.bool, shape=(n, s, k))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel keeps at most {MAX_K} neighbours")
    if sel in ("bisect", "exact", "all") and p > MAX_P:
        raise ValueError(f"P={p}: selection {sel!r} holds at most {MAX_P} points")
    if h2 % 32 or h2 > 1024:
        raise ValueError(f"H2={h2}: must be a multiple of 32 and at most 1024")
    g_per = max(1, _THREADS // h2)
    cap = p if sel == "all" else MAX_K
    lib = _cuda.library()
    smem = lib.t2l_sa_level_smem(p, h1, g_per, cap)
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"SA level needs {smem} B of shared memory per block")
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    if n and s:
        _cuda.launch(
            _KERNEL_OF[sel], f"t2l_sa_level_{sel}",
            *(None if t is None else _cuda.ptr(t)
              for t in (feat, pos, centers, nidx, nmask, w1, wp, ab1, w2, ab2, out)),
            n, p, s, c, h1, h2, k, ctypes.c_float(radius * radius), iters, g_per, cap,
            _cuda.DTYPE_CODE[dt],
        )
    return out


def sa_select_cuda(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float, k: int,
                   selection: str = "first", bisect_iters: int = 12) -> torch.Tensor:
    """fused_sa_select on the card; the arguments as sa_select_plain's."""
    if selection not in ("first", "bisect"):
        raise ValueError(f"selection {selection!r}: expected 'first' or 'bisect'")
    return _launch(selection, feat, pos, centers, None, None, w1, wp, ab1, w2, ab2,
                   radius, k, bisect_iters)


def sa_gather_cuda(feat, centers, idx, mask, w1, wp, ab1, w2, ab2) -> torch.Tensor:
    """fused_sa_gather on the card: idx [N, S, K] int32 (each in [0, P)) and
    mask [N, S, K] bool; the other arguments as sa_gather_plain's."""
    return _launch("gather", feat, None, centers, idx, mask, w1, wp, ab1, w2, ab2,
                   0.0, idx.shape[-1])


def set_abstraction_cuda(x, pos, centers, wx, wp, ab1, w2, ab2, radius: float, k: int,
                         select_k: bool = True) -> torch.Tensor:
    """fused_set_abstraction on the card; the arguments as
    set_abstraction_plain's."""
    return _launch("exact" if select_k else "all", x, pos, centers, None, None, wx, wp,
                   ab1, w2, ab2, radius, k)
