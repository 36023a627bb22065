"""Wrappers of the training set-abstraction kernels (csrc/sa_train_fwd.cu,
csrc/sa_train_bwd.cu, and with e rounded to bf16 csrc/sa_train_e_fwd.cu,
csrc/sa_train_e_bwd.cu): one SA level's forward passes and backward
passes, each returning the raw per-pass sums. The BatchNorm finalization
between passes is host-side tensor arithmetic in ops/sa_train.py, as in the
JAX package."""

from __future__ import annotations

import ctypes
import functools

import torch

from text2loc_tpu_torch.ops import _cuda

KERNEL_FWD = _cuda.Kernel(
    name="sa_train_fwd",
    source="text2loc_tpu_torch/csrc/sa_train_fwd.cu",
    replaces="text2loc_tpu/ops/pallas_sa_train.py:625",
)
KERNEL_BWD = _cuda.Kernel(
    name="sa_train_bwd",
    source="text2loc_tpu_torch/csrc/sa_train_bwd.cu",
    replaces="text2loc_tpu/ops/pallas_sa_train.py:978",
)
KERNEL_E_FWD = _cuda.Kernel(
    name="sa_train_e_fwd",
    source="text2loc_tpu_torch/csrc/sa_train_e_fwd.cu",
    replaces="text2loc_tpu/ops/pallas_sa_train.py:740",
)
KERNEL_E_BWD = _cuda.Kernel(
    name="sa_train_e_bwd",
    source="text2loc_tpu_torch/csrc/sa_train_e_bwd.cu",
    replaces="text2loc_tpu/ops/pallas_sa_train.py:825",
)
MAX_WIDTH = 256    # 8 warps x 4 n8 column tiles (kMaxNQ)
MAX_K = 64         # a center's K edges fit one tile
# Tile layouts (tile rows, W2 resident in shared memory) of the passes that
# form z: a pass takes, of those that hold a center's K edges and fit a
# block's shared memory, the one with the most rows in flight on an SM
# (tile rows x blocks per SM), then the most blocks, then the first in this
# order (csrc/sa_train_tiles.cuh). The forward's BN1 pass takes no tiles
# (NO_TILE).
LAYOUTS = ((128, 1), (128, 0), (64, 1), (64, 0), (32, 1), (32, 0), (16, 1), (16, 0))
NO_TILE = ((0, 0),)
MAX_CENTERS = 16  # centers of a tile (kMaxCenters)


@functools.lru_cache(maxsize=None)
def _plan(direction: str, sym: str, pass_id: int, p: int, k: int, h1: int, h2: int,
          dtype_code: int, layouts: tuple):
    """(tile rows, resident, dynamic shared memory, blocks per SM) of one
    pass's kernel (`direction`: "fwd" or "bwd"; `sym`: the C entry of the
    instantiation), of the given layouts, else of LAYOUTS where none of
    them fits."""
    lib = _cuda.library()
    smem_of = getattr(lib, f"t2l_sa_train_{direction}_smem")
    best = None
    for rows, resident in layouts:
        if rows and rows < k:
            continue
        smem = int(smem_of(pass_id, p, h1, h2, rows, resident, dtype_code))
        if smem > _cuda.SMEM_LIMIT:
            continue
        occ = ctypes.c_int(0)
        err = getattr(lib, sym + "_occupancy")(pass_id, p, k, h1, h2, rows, resident,
                                               dtype_code, ctypes.byref(occ))
        if err:
            raise RuntimeError(f"{sym} occupancy query failed: "
                               f"{lib.t2l_error_string(err).decode()} ({err})")
        if occ.value > 0 and (best is None or (rows * occ.value, occ.value)
                              > (best[0] * best[3], best[3])):
            best = (rows, resident, smem, occ.value)
    if best is not None:
        return best
    if layouts not in (LAYOUTS, NO_TILE):
        return _plan(direction, sym, pass_id, p, k, h1, h2, dtype_code, LAYOUTS)
    raise ValueError(f"SA level P={p} K={k} H1={h1} H2={h2}: no {direction} tile layout "
                     f"fits a block's shared memory ({_cuda.SMEM_LIMIT} bytes)")


class Level:
    """The validated inputs of one SA level's kernels on the card: u [N, P,
    H1] f32, sv [N, S, H1] f32, w2 [H1, H2] f32, idx [N, S, K] int32,
    maskm / maskf [N, S, K] bool, and the compute dtype (f32 or bf16) of the
    in-kernel products. Holds W2 and W2^T in the compute dtype. With
    cache_dtype bfloat16 it runs the kernels that round e to bf16 in every
    pass (the token "e"); None or float32: the recompute kernels."""

    def __init__(self, u, sv, w2, idx, maskm, maskf, compute_dtype, cache_dtype=None):
        if compute_dtype not in _cuda.DTYPE_CODE:
            raise ValueError(f"compute dtype {compute_dtype}: expected f32 or bf16")
        if u.ndim != 3 or idx.ndim != 3:
            raise ValueError(f"u {tuple(u.shape)} / idx {tuple(idx.shape)}: expected 3-D")
        n, p, h1 = u.shape
        s, k = idx.shape[1:]
        h2 = w2.shape[1]
        _cuda.check(u, "u", dtype=torch.float32)
        _cuda.check(sv, "sv", dtype=torch.float32, shape=(n, s, h1))
        _cuda.check(w2, "w2", dtype=torch.float32, shape=(h1, h2))
        _cuda.check(idx, "idx", dtype=torch.int32, shape=(n, s, k))
        _cuda.check(maskm, "maskm", dtype=torch.bool, shape=(n, s, k))
        _cuda.check(maskf, "maskf", dtype=torch.bool, shape=(n, s, k))
        for name, h in (("H1", h1), ("H2", h2)):
            if h % 32 or not 32 <= h <= MAX_WIDTH:
                raise ValueError(f"{name}={h}: must be a multiple of 32 in [32, {MAX_WIDTH}]")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"K={k}: the kernels take 1..{MAX_K} neighbours")
        if n and not bool(((idx >= 0) & (idx < p)).all()):
            raise ValueError(f"idx: neighbour indices outside [0, {p})")
        self.u, self.sv, self.idx, self.maskm, self.maskf = u, sv, idx, maskm, maskf
        self.w2 = w2.to(compute_dtype).contiguous()
        self.w2t = w2.t().to(compute_dtype).contiguous()
        self.dtype_code = _cuda.DTYPE_CODE[compute_dtype]
        self.n, self.p, self.s, self.k, self.h1, self.h2 = n, p, s, k, h1, h2
        if cache_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"cache dtype {cache_dtype}: expected None, f32 or bf16")
        self.kernel_fwd, self.kernel_bwd = KERNEL_FWD, KERNEL_BWD
        self.sym_fwd, self.sym_bwd = "t2l_sa_train_fwd", "t2l_sa_train_bwd"
        if cache_dtype == torch.bfloat16:
            self.kernel_fwd, self.kernel_bwd = KERNEL_E_FWD, KERNEL_E_BWD
            self.sym_fwd, self.sym_bwd = "t2l_sa_train_e_fwd", "t2l_sa_train_e_bwd"
        self.sms = torch.cuda.get_device_properties(u.device).multi_processor_count
        self.fwd_layouts = self.bwd_layouts = LAYOUTS

    def fwd_plan(self, pass_id: int):
        """(tile rows, W2 resident, shared memory bytes, blocks per SM) of
        the forward pass `pass_id` (1 BN1 sums, 2 BN2 sums, 3 out); pass 1
        takes no tiles: (0, 0, 0, blocks per SM)."""
        layouts = NO_TILE if pass_id == 1 else tuple(self.fwd_layouts)
        return _plan("fwd", self.sym_fwd, pass_id, self.p, self.k, self.h1, self.h2,
                     self.dtype_code, layouts)

    def bwd_plan(self, pass_id: int):
        """(tile rows, W2 resident, shared memory bytes, blocks per SM) of
        the backward pass `pass_id` (1 stats, 2 mid, 3 in)."""
        return _plan("bwd", self.sym_bwd, pass_id, self.p, self.k, self.h1, self.h2,
                     self.dtype_code, tuple(self.bwd_layouts))

    def fwd_blocks(self, pass_id: int) -> int:
        """The forward pass's persistent grid: the blocks one wave of SMs
        holds, at most one per cloud."""
        return max(1, min(self.n, self.sms * self.fwd_plan(pass_id)[3]))

    def bwd_blocks(self, pass_id: int) -> int:
        """The backward pass's persistent grid, as fwd_blocks."""
        return max(1, min(self.n, self.sms * self.bwd_plan(pass_id)[3]))

    def fwd_tiles(self, pass_id: int):
        """(tiles, mean filled rows per tile) of the forward pass 2 or 3
        (see _tiles)."""
        return self._tiles(self.fwd_plan(pass_id)[0], MAX_CENTERS)

    def bwd_tiles(self, pass_id: int):
        """(tiles, mean filled rows per tile) of the backward pass (see
        _tiles)."""
        return self._tiles(self.bwd_plan(pass_id)[0], MAX_CENTERS)

    def _tiles(self, rows: int, max_centers: int):
        """(tiles, mean filled rows per tile): each cloud's centers packed in
        order into tiles of `rows` edge rows and at most `max_centers`
        centers, an edge kept where it is valid in either mask, as the
        kernels pack them (for the reports; not on the main path)."""
        kept = (self.maskm | self.maskf).sum(-1)               # [N, S]
        used = torch.zeros(self.n, dtype=kept.dtype, device=kept.device)
        taken = torch.zeros_like(used)
        tiles = torch.full_like(used, 1 if self.s else 0)
        for j in range(self.s):
            c = kept[:, j]
            new = (used + c > rows) | (taken == max_centers)
            tiles += new.to(tiles.dtype)
            used = torch.where(new, c, used + c)
            taken = torch.where(new, torch.ones_like(taken), taken + 1)
        total = int(tiles.sum())
        return total, float(kept.sum()) / max(total, 1)

    def _empty(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.u.device)

    def _fwd(self, pass_id, aux1, aux2, out):
        rows, resident = self.fwd_plan(pass_id)[:2]
        _cuda.launch(self.kernel_fwd, self.sym_fwd, pass_id,
                     *(_cuda.ptr(t) for t in (self.u, self.sv, self.idx, self.maskm,
                                             self.maskf, self.w2, aux1, aux2, out)),
                     self.n, self.p, self.s, self.k, self.h1, self.h2, rows, resident,
                     self.fwd_blocks(pass_id), self.dtype_code)

    def _bwd(self, pass_id, aux1, aux2, dout, outs):
        rows, resident = self.bwd_plan(pass_id)[:2]
        _cuda.launch(self.kernel_bwd, self.sym_bwd, pass_id,
                     *(_cuda.ptr(t) for t in (self.u, self.sv, self.idx, self.maskm,
                                             self.maskf, self.w2, self.w2t, aux1, aux2,
                                             dout, *outs)),
                     self.n, self.p, self.s, self.k, self.h1, self.h2, rows, resident,
                     self.bwd_blocks(pass_id), self.dtype_code)

    def _reduce(self, kernel, part):
        """Sum [blocks, ...] partials over the blocks, in block order."""
        out = self._empty(*part.shape[1:])
        _cuda.launch(kernel, "t2l_sa_train_reduce", _cuda.ptr(part), part.shape[0],
                     out.numel(), _cuda.ptr(out))
        return out

    def _check_aux(self, aux1, aux2):
        _cuda.check(aux1, "aux1", dtype=torch.float32, shape=(8, self.h1))
        _cuda.check(aux2, "aux2", dtype=torch.float32, shape=(8, self.h2))

    # ----------------------------------------------------------- forward

    def stats(self, layer: int, aux1, aux2):
        """[2, H] (sum, sum of squares) over maskf edges of e (layer 1) or z
        (layer 2)."""
        self._check_aux(aux1, aux2)
        h = self.h1 if layer == 1 else self.h2
        part = self._empty(self.fwd_blocks(layer), 2, h)
        self._fwd(layer, aux1, aux2, part)
        return self._reduce(self.kernel_fwd, part)

    def out(self, aux1, aux2):
        """[N, S, H2] f32: the neighbour max of relu(BN2(z)), 0 on empty rows."""
        self._check_aux(aux1, aux2)
        out = self._empty(self.n, self.s, self.h2)
        self._fwd(3, aux1, aux2, out)
        return out

    # ---------------------------------------------------------- backward

    def bwd_stats(self, aux1, aux2, dout):
        """[2, H2]: (sum dy2, sum dy2 * yhat2) over all edges."""
        self._check_aux(aux1, aux2)
        _cuda.check(dout, "dout", dtype=torch.float32, shape=(self.n, self.s, self.h2))
        part = self._empty(self.bwd_blocks(1), 2, self.h2)
        self._bwd(1, aux1, aux2, dout, (part, part, part))
        return self._reduce(self.kernel_bwd, part)

    def bwd_mid(self, aux1, aux2, dout):
        """([2, H1] (sum dy1, sum dy1 * yhat1), dW2 [H1, H2], db2 [H2]);
        aux2 rows 4-5 hold A2/n and B2/n."""
        self._check_aux(aux1, aux2)
        _cuda.check(dout, "dout", dtype=torch.float32, shape=(self.n, self.s, self.h2))
        blocks = self.bwd_blocks(2)
        part_a = self._empty(blocks, 2, self.h1)
        part_w = self._empty(blocks, self.h1, self.h2)
        part_b = self._empty(blocks, self.h2)
        self._bwd(2, aux1, aux2, dout, (part_a, part_w, part_b))
        return (self._reduce(self.kernel_bwd, part_a), self._reduce(self.kernel_bwd, part_w),
                self._reduce(self.kernel_bwd, part_b))

    def bwd_in(self, aux1, aux2, dout):
        """(du [N, P, H1], dsv [N, S, H1]); aux rows 4-5 hold the correction
        sums / n of both layers."""
        self._check_aux(aux1, aux2)
        _cuda.check(dout, "dout", dtype=torch.float32, shape=(self.n, self.s, self.h2))
        du = self._empty(self.n, self.p, self.h1)
        dsv = self._empty(self.n, self.s, self.h1)
        if self.n:
            self._bwd(3, aux1, aux2, dout, (du, dsv, du))
        return du, dsv
