"""Wrappers of the inference SA kernels: the selections "first", "bisect",
"gather", "exact" and "all" on the tensor-core tile kernel
(csrc/sa_select_tc.cuh, instantiated in csrc/sa_select.cu,
csrc/sa_select_bisect.cu, csrc/sa_gather.cu, csrc/sa_exact.cu and
csrc/sa_all.cu, each with its C entries t2l_sa_<selection>), the plan from
tile_plan. Every selection has its own launch count."""

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
TILE_KERNELS = {"first": KERNEL_FIRST, "bisect": KERNEL_BISECT, "gather": KERNEL_GATHER,
                "exact": KERNEL_EXACT, "all": KERNEL_ALL}
MAX_K = 32         # neighbour slots per center (every selection but "all")
MAX_P = 256        # points "bisect" and "exact" hold in registers (8 a lane; kMaxRegP)
U_F32 = ("exact", "all")   # u = x @ Wx + pos @ Wp kept in f32, not rounded

# The tile kernel (csrc/sa_select_tc.cuh): its limits (check_args) and the
# constants its shared-memory layout is built from.
SLICE = 256        # output columns of one product: 8 warps x 4 n8 tiles (kSlice)
KC = 32            # k rows of a ring chunk (kKC): H1 and C+3 are padded to it
GROUP = 128        # centers selected at once by every selection but "all" (kGroup)
MAX_H1 = 1024      # a thread owns one column chunk of h1
MAX_P_TILES = 65535  # a row's point in 16 bits
MAX_S_ALL = 32767    # "all": a row's center in 15 bits (kMaxAllCenters)
# Tile layouts (edge rows, W2 resident in shared memory): the plan takes, of
# those the selection takes that fit a block's shared memory, the one with
# the most rows in flight on an SM (rows x blocks per SM), then the taller
# tile (a tile costs a fixed chain of phases), then the most blocks, then
# the first in this order.
TILE_LAYOUTS = ((128, 1), (128, 0), (64, 1), (64, 0), (32, 1), (32, 0), (16, 1), (16, 0))
# "all": row map budgets (rows of a group of centers), the largest first; a
# budget holds any center's up to P rows, so P <= ALL_BUDGETS[0].
ALL_BUDGETS = (4096, 2048, 1024, 512, 256)


class TilePlan(NamedTuple):
    rows: int           # edge rows of a tile (a multiple of 16; first, gather: at least K)
    resident: int       # W2 held in shared memory (1) or streamed through the ring (0)
    smem: int           # dynamic shared bytes of a block
    blocks_per_sm: int  # blocks one SM holds: the persistent grid's wave
    slices: int         # products of at most SLICE output columns a tile takes
    budget: int         # "all": rows of the row map (a group's rows); 0 for the others


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


def check_level(p: int, s: int, c: int, h1: int, h2: int, k: int,
                selection: str = "first") -> None:
    """Raise ValueError, with the reason, on a level the tile kernel of
    `selection` does not take (c: its input channels, C+3 for "first",
    "bisect" and "gather", C for "exact" and "all"; k: the neighbours a
    center keeps, which "all" does not read)."""
    if selection not in TILE_KERNELS:
        raise ValueError(f"selection {selection!r}: the tile kernel takes "
                         f"{tuple(TILE_KERNELS)}")
    if selection != "all" and not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}: the kernel keeps 1..{MAX_K} neighbours a center")
    for name, h in (("H1", h1), ("H2", h2)):
        if h < 8 or h % 8:
            raise ValueError(f"{name}={h}: must be a positive multiple of 8 (n8 tiles)")
    if h1 > MAX_H1:
        raise ValueError(f"H1={h1}: at most {MAX_H1}")
    if not 1 <= p <= MAX_P_TILES or c < 1:
        raise ValueError(f"P={p}, C={c}: the kernel takes 1..{MAX_P_TILES} points and "
                         f"at least one channel")
    if selection in ("bisect", "exact") and p > MAX_P:
        raise ValueError(f"P={p}: selection {selection!r} holds at most {MAX_P} points "
                         f"(8 a lane in registers)")
    if selection == "all":
        if p > ALL_BUDGETS[0]:
            raise ValueError(f"P={p}: selection 'all' takes at most {ALL_BUDGETS[0]} "
                             f"points (a center's rows fit one row map)")
        if s > MAX_S_ALL:
            raise ValueError(f"S={s}: selection 'all' takes at most {MAX_S_ALL} centers")


def select_smem(p: int, s: int, c: int, h1: int, h2: int, k: int, rows: int,
                resident: int, dtype, selection: str = "first", budget: int = 0) -> int:
    """Dynamic shared bytes of one block: layout() of csrc/sa_select_tc.cuh
    (every buffer 16-byte aligned). Resident W2 [H1k][H2 + pad] (H1k: H1
    padded to KC); u [P][H1 + pad] in the dtype ("exact", "all": [P][H1 + 4]
    in f32); points (not for "gather"), BN1 and Wp in f32; the centers of a
    group (G = min(S, GROUP); "all": the cloud's S), their lists (not for "all"),
    counts, first rows, tiles (not for "all") and row map (G K entries;
    "all": `budget`); then the larger of the u pass's scratch (feat rows of
    64 points, the W1 ring) and a tile's (h1 rows with y over them, y apart
    above SLICE columns, the W2 ring where W2 streams)."""
    es = 2 if dtype == torch.bfloat16 else 4
    pad = 8 if es == 2 else 4
    is_all = selection == "all"    # rows by the budget, no lists
    h1k, ck = _round_up(h1, KC), _round_up(c, KC)
    w1n, w2n = min(h1, SLICE), min(h2, SLICE)
    g = max(s, 1) if is_all else min(max(s, 1), GROUP)
    fixed = (es * h1k * (h2 + pad) if resident else 0,
             4 * p * (h1 + 4) if selection in U_F32 else es * p * (h1 + pad),
             0 if selection == "gather" else 12 * p, 20 * h1, 16 * g,
             0 if is_all else 2 * g * k, 4 * g, 4 * (g + 1), 0 if is_all else 4 * (g + 1),
             4 * budget if is_all else 4 * g * k, 0 if is_all else 8)
    u_pass = _align16(es * 64 * (ck + pad)) + _align16(es * 2 * KC * (w1n + pad))
    hs, ys = es * rows * (h1k + pad), es * rows * (w2n + pad)
    tile = _align16(hs) + _align16(ys) if h2 > SLICE else _align16(max(hs, ys))
    tile += 0 if resident else _align16(es * 2 * KC * (w2n + pad))
    return sum(_align16(b) for b in fixed) + max(u_pass, tile)


def tile_layouts(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype,
                 selection: str = "first"):
    """[(rows, resident, smem, budget)] of TILE_LAYOUTS (for "all" each with
    every budget of ALL_BUDGETS that holds P rows, the largest first) that
    the selection and the level's width class take and that fit a block's
    shared memory, in that order; raises where the kernel does not take the
    level. Every selection but "all" needs R >= K (a center in one tile)."""
    check_level(p, s, c, h1, h2, k, selection)
    budgets = [b for b in ALL_BUDGETS if b >= p] if selection == "all" else [0]
    out = []
    for rows, resident in TILE_LAYOUTS:
        if (selection != "all" and rows < k) or rows > max_rows(h1, h2):
            continue
        for budget in budgets:
            smem = select_smem(p, s, c, h1, h2, k, rows, resident, dtype, selection, budget)
            if smem <= _cuda.SMEM_LIMIT:
                out.append((rows, resident, smem, budget))
    return out


def pick_plan(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype,
              occupancy: Callable[[int, int, int, int], int],
              selection: str = "first") -> TilePlan:
    """The plan of a level: of tile_layouts, the most rows in flight on an
    SM (rows x blocks per SM), then the taller tile, then the most blocks,
    then the first; `occupancy(rows, resident, smem, budget)` gives the
    blocks per SM."""
    best, key = None, None
    for rows, resident, smem, budget in tile_layouts(p, s, c, h1, h2, k, dtype, selection):
        occ = occupancy(rows, resident, smem, budget)
        if occ > 0 and (best is None or (rows * occ, rows, occ) > key):
            best = TilePlan(rows, resident, smem, occ, -(-h2 // SLICE), budget)
            key = (rows * occ, rows, occ)
    if best is None:
        raise ValueError(f"SA level P={p} S={s} C={c} H1={h1} H2={h2} K={k}: no tile "
                         f"layout fits a block's shared memory ({_cuda.SMEM_LIMIT} bytes)")
    return best


@functools.lru_cache(maxsize=None)
def tile_plan(p: int, s: int, c: int, h1: int, h2: int, k: int, dtype,
              selection: str = "first") -> TilePlan:
    """pick_plan with the card's occupancy query; the kernel's own layout
    must size each candidate as select_smem does."""
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dtype]

    def occupancy(rows, resident, smem, budget):
        c_smem = getattr(lib, f"t2l_sa_{selection}_layout")(p, s, c, h1, h2, k, rows,
                                                            resident, budget, code)
        if c_smem != smem:
            raise RuntimeError(f"sa {selection} layout: {c_smem} bytes on the card, "
                               f"{smem} by select_smem")
        occ = ctypes.c_int(0)
        err = getattr(lib, f"t2l_sa_{selection}_occupancy")(
            p, s, c, h1, h2, k, rows, resident, budget, code, ctypes.byref(occ))
        if err:
            raise RuntimeError(f"sa {selection} occupancy query failed: "
                               f"{lib.t2l_error_string(err).decode()} ({err})")
        return occ.value

    return pick_plan(p, s, c, h1, h2, k, dtype, occupancy, selection)


def all_groups(counts, budget: int) -> list:
    """The groups the "all" kernel cuts a cloud's centers into, [(g0, g1)]:
    from g0, the most consecutive centers whose rows (counts: in-radius
    points per center) fit `budget`; every center holds at most P <= budget
    rows, so a group holds at least one. A group's rows are cut into tiles
    of the plan's R rows, across center boundaries."""
    groups, g0, n = [], 0, len(counts)
    while g0 < n:
        g1, rows = g0 + 1, counts[g0]
        while g1 < n and rows + counts[g1] <= budget:
            rows += counts[g1]
            g1 += 1
        groups.append((g0, g1))
        g0 = g1
    return groups


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


def _launch_tiles(selection: str, feat, pos, centers, idx, mask, w1, wp, ab1, w2, ab2,
                  radius: float, k: int, iters: int = 0) -> torch.Tensor:
    """Check the arguments and launch the tile kernel of `selection` on its
    plan (iters: the bisection's rounds, "bisect" only): [N, S, H2] in
    feat.dtype."""
    gather = selection == "gather"
    n, p, c, s, h1, h2 = _check_level(feat, pos, centers, w1, wp, ab1, w2, ab2, gather)
    dt = feat.dtype
    if gather:
        _cuda.check(idx, "idx", dtype=torch.int32, shape=(n, s, k))
        _cuda.check(mask, "mask", dtype=torch.bool, shape=(n, s, k))
    check_level(p, s, c, h1, h2, k, selection)
    plan = tile_plan(p, s, c, h1, h2, k, dt, selection)
    for name, t in (("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies it 16 bytes at a time; its data "
                             f"must be 16-byte aligned")
    out = torch.empty((n, s, h2), dtype=dt, device=feat.device)
    if n and s:
        blocks = max(1, min(n, _cuda.sm_count(feat.device.index) * plan.blocks_per_sm))
        _cuda.launch(
            TILE_KERNELS[selection], f"t2l_sa_{selection}",
            *(None if t is None else _cuda.ptr(t)
              for t in (feat, pos, centers, idx, mask, w1, wp, ab1, w2, ab2, out)),
            n, p, s, c, h1, h2, k, ctypes.c_float(radius * radius), iters, plan.rows,
            plan.resident, plan.budget, blocks, _cuda.DTYPE_CODE[dt],
        )
    return out


def sa_select_cuda(feat, pos, centers, w1, wp, ab1, w2, ab2, radius: float, k: int,
                   selection: str = "first", bisect_iters: int = 12) -> torch.Tensor:
    """fused_sa_select on the card; the arguments as sa_select_plain's."""
    if selection not in ("first", "bisect"):
        raise ValueError(f"selection {selection!r}: expected 'first' or 'bisect'")
    return _launch_tiles(selection, feat, pos, centers, None, None, w1, wp, ab1, w2, ab2,
                         radius, k, bisect_iters if selection == "bisect" else 0)


def sa_gather_cuda(feat, centers, idx, mask, w1, wp, ab1, w2, ab2) -> torch.Tensor:
    """fused_sa_gather on the card: idx [N, S, K] int32 (each in [0, P)) and
    mask [N, S, K] bool; the other arguments as sa_gather_plain's."""
    return _launch_tiles("gather", feat, None, centers, idx, mask, w1, wp, ab1, w2, ab2,
                         0.0, idx.shape[-1])


def set_abstraction_cuda(x, pos, centers, wx, wp, ab1, w2, ab2, radius: float, k: int,
                         select_k: bool = True) -> torch.Tensor:
    """fused_set_abstraction on the card; the arguments as
    set_abstraction_plain's."""
    return _launch_tiles("exact" if select_k else "all", x, pos, centers, None, None, wx, wp,
                         ab1, w2, ab2, radius, k)
