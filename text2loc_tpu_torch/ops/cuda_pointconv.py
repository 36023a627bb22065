"""Wrappers of the inference SA kernels: selection "first" on the tensor
cores (csrc/sa_select.cu, csrc/sa_select_tc.cuh: tiles of packed valid
edges, the plan from first_plan), and the four other selections on one
template (csrc/sa_level.cuh), each built from its own source with its own C
entry point t2l_sa_level_<selection> and its own launch count."""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

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
_KERNEL_OF = dict(zip(("bisect", "gather", "exact", "all"), KERNELS[1:]))
MAX_K = 32         # neighbour slots per tile
MAX_P = 256        # points the register-resident selections hold (8 per lane)
_THREADS = 256

# The "first" kernel (csrc/sa_select_tc.cuh): its limits (check_args) and
# the constants its shared-memory layout is built from.
SLICE = 256        # output columns of one product: 8 warps x 4 n8 tiles (kSlice)
KC = 32            # k rows of a ring chunk (kKC): H1 and C+3 are padded to it
GROUP = 128        # centers selected at once (kGroup)
MAX_H1 = 1024      # a thread owns one column chunk of h1
MAX_P_FIRST = 65535  # a row's point in 16 bits
# Tile layouts (edge rows, W2 resident in shared memory): the plan takes, of
# those that hold a center's K edges and fit a block's shared memory, the
# one with the most rows in flight on an SM (rows x blocks per SM), then
# the most blocks, then the first in this order.
FIRST_LAYOUTS = ((128, 1), (128, 0), (64, 1), (64, 0), (32, 1), (32, 0), (16, 1), (16, 0))


class FirstPlan(NamedTuple):
    rows: int           # edge rows of a tile (a multiple of 16, at least K)
    resident: int       # W2 held in shared memory (1) or streamed through the ring (0)
    smem: int           # dynamic shared bytes of a block
    blocks_per_sm: int  # blocks one SM holds: the persistent grid's wave
    slices: int         # products of at most SLICE output columns a tile takes


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def width_class(h1: int, h2: int) -> int:
    """n8 column tiles a warp owns in the level's widest product slice: 1,
    2 or 4 for at most 64, 128 or SLICE columns."""
    hm = max(min(h1, SLICE), min(h2, SLICE))
    return 1 if hm <= 64 else 2 if hm <= 128 else 4


def max_rows(h1: int, h2: int) -> int:
    """The tallest tile of a level: 16 x its width class's m16 row tiles."""
    return 64 if width_class(h1, h2) == 4 else 128


def check_first(p: int, c: int, h1: int, h2: int, k: int) -> None:
    """Raise ValueError, with the reason, on a level the "first" kernel does
    not take (c: the C+3 input channels)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}: the kernel keeps 1..{MAX_K} neighbours a center")
    for name, h in (("H1", h1), ("H2", h2)):
        if h < 8 or h % 8:
            raise ValueError(f"{name}={h}: must be a positive multiple of 8 (n8 tiles)")
    if h1 > MAX_H1:
        raise ValueError(f"H1={h1}: at most {MAX_H1}")
    if not 1 <= p <= MAX_P_FIRST or c < 1:
        raise ValueError(f"P={p}, C={c}: the kernel takes 1..{MAX_P_FIRST} points and "
                         f"at least one channel")


def select_smem(p: int, s: int, c: int, h1: int, h2: int, k: int, rows: int,
                resident: int, dtype) -> int:
    """Dynamic shared bytes of one block: layout() of csrc/sa_select_tc.cuh
    (every buffer 16-byte aligned). Resident W2 [H1k][H2 + pad] (H1k: H1
    padded to KC); u [P][H1 + pad] in the dtype; points, BN1 and Wp in f32;
    a group's G = min(S, GROUP) centers, lists, counts, first rows, tiles
    and row map; then the larger of the u pass's scratch (feat rows of 64
    points, the W1 ring) and a tile's (h1 rows with y over them, y apart
    above SLICE columns, the W2 ring where W2 streams)."""
    es = 2 if dtype == torch.bfloat16 else 4
    pad = 8 if es == 2 else 4
    h1k, ck = _round_up(h1, KC), _round_up(c, KC)
    w1n, w2n = min(h1, SLICE), min(h2, SLICE)
    g = min(max(s, 1), GROUP)
    fixed = (es * h1k * (h2 + pad) if resident else 0, es * p * (h1 + pad), 12 * p, 20 * h1,
             16 * g, 2 * g * k, 4 * g, 4 * (g + 1), 4 * (g + 1), 4 * g * k, 8)
    u_pass = _align16(es * 64 * (ck + pad)) + _align16(es * 2 * KC * (w1n + pad))
    hs, ys = es * rows * (h1k + pad), es * rows * (w2n + pad)
    tile = _align16(hs) + _align16(ys) if h2 > SLICE else _align16(max(hs, ys))
    tile += 0 if resident else _align16(es * 2 * KC * (w2n + pad))
    return sum(_align16(b) for b in fixed) + max(u_pass, tile)


def first_layouts(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype):
    """[(rows, resident, smem)] of FIRST_LAYOUTS that hold a center's K edges,
    the level's width class takes and fit a block's shared memory, in that
    order; raises where the kernel does not take the level."""
    check_first(p, c, h1, h2, k)
    out = []
    for rows, resident in FIRST_LAYOUTS:
        if rows < k or rows > max_rows(h1, h2):
            continue
        smem = select_smem(p, s, c, h1, h2, k, rows, resident, dtype)
        if smem <= _cuda.SMEM_LIMIT:
            out.append((rows, resident, smem))
    return out


def pick_plan(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype,
              occupancy: Callable[[int, int, int], int]) -> FirstPlan:
    """The plan of a level: of first_layouts, the most rows in flight on an
    SM (rows x blocks per SM), then the most blocks, then the first;
    `occupancy(rows, resident, smem)` gives the blocks per SM."""
    best = None
    for rows, resident, smem in first_layouts(p, s, c, h1, h2, k, dtype):
        occ = occupancy(rows, resident, smem)
        if occ > 0 and (best is None or (rows * occ, occ) > (best.rows * best.blocks_per_sm,
                                                             best.blocks_per_sm)):
            best = FirstPlan(rows, resident, smem, occ, -(-h2 // SLICE))
    if best is None:
        raise ValueError(f"SA level P={p} S={s} C={c} H1={h1} H2={h2} K={k}: no tile "
                         f"layout fits a block's shared memory ({_cuda.SMEM_LIMIT} bytes)")
    return best


@functools.lru_cache(maxsize=None)
def first_plan(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype) -> FirstPlan:
    """pick_plan with the card's occupancy query; the kernel's own layout
    must size each candidate as select_smem does."""
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dtype]

    def occupancy(rows, resident, smem):
        c_smem = lib.t2l_sa_select_layout(p, s, c, h1, h2, k, rows, resident, code)
        if c_smem != smem:
            raise RuntimeError(f"sa_select_first layout: {c_smem} bytes on the card, "
                               f"{smem} by select_smem")
        occ = ctypes.c_int(0)
        err = lib.t2l_sa_select_occupancy(p, s, c, h1, h2, k, rows, resident, code,
                                          ctypes.byref(occ))
        if err:
            raise RuntimeError(f"sa_select_first occupancy query failed: "
                               f"{lib.t2l_error_string(err).decode()} ({err})")
        return occ.value

    return pick_plan(p, s, c, h1, h2, k, dtype, occupancy)


def _check_level(feat, pos, centers, w1, wp, ab1, w2, ab2, gather):
    """Validate one level's tensors: (n, p, c, s, h1, h2)."""
    dt = feat.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"feat: unsupported dtype {dt}")
    if feat.ndim != 3:
        raise ValueError(f"feat: expected [N, P, C], got {tuple(feat.shape)}")
    n, p, c = feat.shape
    s = centers.shape[1]
    h1, h2 = w1.shape[1], w2.shape[1]
    _cuda.check(feat, "feat", dtype=dt)
    if not gather:
        _cuda.check(pos, "pos", dtype=torch.float32, shape=(n, p, 3))
    _cuda.check(centers, "centers", dtype=torch.float32, shape=(n, s, 3))
    _cuda.check(w1, "w1", dtype=dt, shape=(c, h1))
    _cuda.check(wp, "wp", dtype=dt, shape=(3, h1))
    _cuda.check(ab1, "ab1", dtype=torch.float32, shape=(2, h1))
    _cuda.check(w2, "w2", dtype=dt, shape=(h1, h2))
    _cuda.check(ab2, "ab2", dtype=torch.float32, shape=(2, h2))
    return n, p, c, s, h1, h2


def _launch_first(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float,
                  k: int) -> torch.Tensor:
    """Check the arguments and launch the "first" kernel on its plan: [N, S,
    H2] in feat.dtype."""
    n, p, c, s, h1, h2 = _check_level(feat, pos, centers, w1, wp, ab1, w2, ab2, False)
    dt = feat.dtype
    check_first(p, c, h1, h2, k)
    plan = first_plan(p, s, c, h1, h2, k, dt)
    for name, t in (("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies it 16 bytes at a time; its data "
                             f"must be 16-byte aligned")
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    if n and s:
        blocks = max(1, min(n, _cuda.sm_count(feat.device.index) * plan.blocks_per_sm))
        _cuda.launch(
            KERNEL_FIRST, "t2l_sa_select_first",
            *(_cuda.ptr(t) for t in (feat, pos, centers, w1, wp, ab1, w2, ab2, out)),
            n, p, s, c, h1, h2, k, ctypes.c_float(radius * radius), plan.rows,
            plan.resident, blocks, _cuda.DTYPE_CODE[dt],
        )
    return out


def _launch(sel: str, feat, pos, centers, nidx, nmask, w1, wp, ab1, w2, ab2,
            radius: float, k: int, iters: int = 0) -> torch.Tensor:
    """Check the arguments and launch selection `sel` of sa_level.cuh: [N, S,
    H2] in feat.dtype."""
    n, p, c, s, h1, h2 = _check_level(feat, pos, centers, w1, wp, ab1, w2, ab2,
                                      sel == "gather")
    dt = feat.dtype
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
    if selection == "first":
        return _launch_first(feat, pos, centers, w1, wp, ab1, w2, ab2, radius, k)
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
