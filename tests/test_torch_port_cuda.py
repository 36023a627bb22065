"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file needs no jax; where jax is not installed, run it without the
suite's conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances: FPS bit-equal; the others at 1e-4 x max|plain| in f32 and
2e-2 x max|plain| in bf16 (sums in another order, bf16 rounding points of
the kernel's own). The training SA level's gradients are held by relative
L2 error (1e-3 f32, 2e-2 bf16): the ReLUs have discontinuous backwards, and
z differs from the plain version's in the last bits; norms are floored at
1e-3 x the largest gradient norm of the level, since db2 and the BN shift
gradients are near zero by BN shift invariance (sums of cancelling terms).
The neighbour max moves a (center, column)'s whole dout to its winning
edge, so where two edges tie within f32 rounding (or the winner sits at
the ReLU's kink) either side may pick another winner and move O(1) of
gradient: both backwards take dout with zeros at the pairs
ops/sa_train.near_ties marks, as chip_smoke.py's check does. The add+LN kernel: f32 within 1e-6
x max|plain| (the same two-pass formulas, sums in another order), bf16
within one bf16 ulp per element (an f32 difference in the last bit can
round the other way; the ulp of max(|plain|, 2^-8): a smaller output is a
cancellation of terms of order 0.1-1, where the f32 sums differ by more
than the bf16 spacing at the result). The row gather is bit-equal; the scatter-add within
1e-6 x max|plain| of the CPU's index-order sum (the kernel sums each
point's rows in q order too; the CUDA index_add_ does not).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from text2loc_tpu_torch.ops import (_cuda, cuda_ffn, cuda_fps, cuda_gather, cuda_ln, cuda_mha,
                                    cuda_pointconv, cuda_sa_train)
from text2loc_tpu_torch.ops.ffn import (ffn_addln, ffn_addln_plain, ffn_hidden_plain,
                                        ffn_out_addln_plain)
from text2loc_tpu_torch.ops.gather import (gather_rows, gather_rows_grad, gather_rows_plain,
                                           scatter_rows, scatter_rows_plain)
from text2loc_tpu_torch.ops.ln import add_layernorm, add_layernorm_plain
from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain, fps_gather
from text2loc_tpu_torch.ops.mha import (mha_addln, mha_addln_plain, mha_core_plain,
                                        mha_out_addln_plain, mha_project_plain)
from text2loc_tpu_torch.ops.ballquery import ball_query_knn, squared_distances
from text2loc_tpu_torch.ops.pointconv import (
    sa_gather,
    sa_gather_plain,
    sa_select,
    sa_select_plain,
    set_abstraction,
    set_abstraction_plain,
)
from text2loc_tpu_torch.ops.sa_train import (_forward_plain, backward_cuda, forward_cuda,
                                             near_ties, sa_train, sa_train_backward_plain,
                                             sa_train_plain)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_L2 = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= REL[dtype] * want.abs().max().item(), err


def _randn(rng, shape, dev, scale=1.0, mean=0.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale + mean).astype(np.float32)).to(dev)


def test_fps_kernel_bit_equal(dev):
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.random((40, 256, 3)).astype(np.float32)).to(dev)
    pts[:, 100:110] = pts[:, 0:10]                    # exact distance ties
    before = cuda_fps.KERNEL.launches
    sub, idx = fps_gather(pts, 128)
    assert cuda_fps.KERNEL.launches == before + 1
    want_idx, want_xyz = farthest_point_sampling_plain(pts, 128)
    assert torch.equal(idx, want_idx) and torch.equal(sub, want_xyz)


def _fps_clouds(rng, n, p, kind):
    pts = rng.random((n, p, 3)).astype(np.float32)
    if kind == "ties":                 # duplicated points: exact distance ties
        pts[:, p // 2:] = pts[:, : p - p // 2]
    elif kind == "equal":              # a padded cloud: every point the same
        pts[:] = pts[:, :1]
    elif kind == "grid":               # integer grid: many equal distances
        pts = rng.integers(0, 3, (n, p, 3)).astype(np.float32)
    return pts


def _fps_check(dev, pts, s):
    pts = torch.from_numpy(pts).to(dev)
    before = cuda_fps.KERNEL.launches
    idx, xyz = cuda_fps.farthest_point_sampling_cuda(pts, s)
    assert cuda_fps.KERNEL.launches == before + 1
    want_idx, want_xyz = farthest_point_sampling_plain(pts, s)
    assert torch.equal(idx, want_idx) and torch.equal(xyz, want_xyz)


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "grid"])
@pytest.mark.parametrize("p", [1, 31, 32, 33, 255, 256, 257, 512, 513])
def test_fps_kernel_variants(dev, p, kind):
    """Both variants (warp to P=512, block above) at S of 1, 128 and P,
    N = 1 and N = 37 (a block's second warp without a cloud)."""
    rng = np.random.default_rng(p)
    for n in (1, 37):
        pts = _fps_clouds(rng, n, p, kind)
        for s in sorted({1, min(p, 128), p}):
            _fps_check(dev, pts, s)


def test_fps_kernel_largest_cloud(dev):
    """The largest P the wrapper takes (the block variant's shared memory)."""
    p = (_cuda.SMEM_LIMIT - cuda_fps.BLOCK_STATIC_SMEM) // 4
    rng = np.random.default_rng(11)
    pts = _fps_clouds(rng, 2, p, "ties")
    for s in (1, 128, p):
        _fps_check(dev, pts, s)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(torch.rand(1, p + 1, 3, device=dev), 1)


@pytest.mark.parametrize("p", [1, 33, 256, 512, 513, 4096])
def test_fps_plan_is_the_kernels(dev, p):
    lib = _cuda.library()
    for s in (1, p):
        plan = cuda_fps.fps_plan(p, s)
        assert lib.t2l_fps_smem(p, s, plan.per_lane, plan.warps) == plan.smem


@pytest.mark.parametrize("dtype", DTYPES)
def test_sa_select_kernel(dev, dtype):
    rng = np.random.default_rng(1)
    n, p, s, c, h1, h2 = 20, 128, 64, 67, 128, 128
    pos = torch.from_numpy(rng.random((n, p, 3)).astype(np.float32) - 0.5).to(dev)
    pos[:, 90:100] = pos[:, 0:10]                     # duplicate points
    ctr = pos[:, :s].contiguous()
    ctr[0, 5] = 9.0                                   # an empty-radius row
    feat = torch.cat([_randn(rng, (n, p, c - 3), dev), pos], -1).to(dtype).contiguous()
    w1 = _randn(rng, (c, h1), dev, c ** -0.5).to(dtype)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5).to(dtype)
    ab1 = torch.stack([_randn(rng, h1, dev, 0.1, 1.0), _randn(rng, h1, dev, 0.1)])
    ab2 = torch.stack([_randn(rng, h2, dev, 0.1, 1.0), _randn(rng, h2, dev, 0.1)])
    args = (feat, pos, ctr, w1, w1[c - 3:].contiguous(), ab1, w2, ab2, 0.3, 32)
    before = cuda_pointconv.KERNEL_FIRST.launches
    got = sa_select(*args)
    assert cuda_pointconv.KERNEL_FIRST.launches == before + 1
    _close(got, sa_select_plain(*args), dtype)
    assert (got[0, 5] == 0).all()


def _sa_level_inputs(rng, dev, dtype, n, p, s, c, h1, h2, voxel=False):
    """feat = concat(x, pos) and the weights of one SA level; `voxel`: points
    on a 1/16 grid, so that many distances tie exactly."""
    if voxel:
        pos = rng.integers(-8, 9, (n, p, 3)) / 16.0
    else:
        pos = rng.random((n, p, 3)) - 0.5
    pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    ctr = pos[:, :s].contiguous()
    ctr[0, 5] = 9.0                                   # an empty-radius row
    x = _randn(rng, (n, p, c - 3), dev).to(dtype).contiguous()
    feat = torch.cat([x, pos.to(dtype)], -1).contiguous()
    w1 = _randn(rng, (c, h1), dev, c ** -0.5).to(dtype)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5).to(dtype)
    ab1 = torch.stack([_randn(rng, h1, dev, 0.1, 1.0), _randn(rng, h1, dev, 0.1)])
    ab2 = torch.stack([_randn(rng, h2, dev, 0.1, 1.0), _randn(rng, h2, dev, 0.1)])
    return dict(x=x, feat=feat, pos=pos, ctr=ctr, w1=w1, wx=w1[:c - 3].contiguous(),
                wp=w1[c - 3:].contiguous(), ab1=ab1, w2=w2, ab2=ab2)


SA_SHAPES = [(12, 256, 128, 6, 32, 64, 0.2), (9, 128, 64, 67, 128, 128, 0.3),
             (5, 64, 32, 131, 256, 256, 0.4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("voxel,iters", [(False, 12), (True, 12), (True, 4)])
def test_sa_select_bisect_kernel(dev, dtype, shape, voxel, iters):
    rng = np.random.default_rng(7)
    n, p, s, c, h1, h2, radius = shape
    a = _sa_level_inputs(rng, dev, dtype, n, p, s, c, h1, h2, voxel)
    args = (a["feat"], a["pos"], a["ctr"], a["w1"], a["wp"], a["ab1"], a["w2"],
            a["ab2"], radius, 32)
    before = cuda_pointconv.KERNEL_BISECT.launches
    got = sa_select(*args, selection="bisect", bisect_iters=iters)
    assert cuda_pointconv.KERNEL_BISECT.launches == before + 1
    _close(got, sa_select_plain(*args, selection="bisect", bisect_iters=iters), dtype)
    assert (got[0, 5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("approx", [False, True])
def test_sa_gather_kernel(dev, dtype, shape, approx):
    rng = np.random.default_rng(8)
    n, p, s, c, h1, h2, radius = shape
    a = _sa_level_inputs(rng, dev, dtype, n, p, s, c, h1, h2, voxel=approx)
    idx, mask = ball_query_knn(a["pos"], a["ctr"], radius, 32, approx=approx)
    args = (a["feat"], a["ctr"], idx, mask, a["w1"], a["wp"], a["ab1"], a["w2"], a["ab2"])
    before = cuda_pointconv.KERNEL_GATHER.launches
    got = sa_gather(*args)
    assert cuda_pointconv.KERNEL_GATHER.launches == before + 1
    _close(got, sa_gather_plain(*args), dtype)
    assert (got[0, 5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("select_k", [True, False])
def test_set_abstraction_kernel(dev, dtype, shape, select_k):
    rng = np.random.default_rng(9)
    n, p, s, c, h1, h2, radius = shape
    a = _sa_level_inputs(rng, dev, dtype, n, p, s, c, h1, h2, voxel=select_k)
    args = (a["x"], a["pos"], a["ctr"], a["wx"], a["wp"], a["ab1"], a["w2"], a["ab2"],
            radius, 32)
    kernel = cuda_pointconv.KERNEL_EXACT if select_k else cuda_pointconv.KERNEL_ALL
    before = kernel.launches
    got = set_abstraction(*args, select_k=select_k)
    assert kernel.launches == before + 1
    _close(got, set_abstraction_plain(*args, select_k=select_k), dtype)
    assert (got[0, 5] == 0).all()


def test_sa_level_wrappers_reject_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(10)
    a = _sa_level_inputs(rng, dev, torch.float32, 2, 320, 16, 6, 32, 64)
    with pytest.raises(ValueError, match="at most 256"):
        sa_select(a["feat"], a["pos"], a["ctr"], a["w1"], a["wp"], a["ab1"], a["w2"],
                  a["ab2"], 0.2, 32, selection="bisect")
    with pytest.raises(ValueError, match="selection"):
        sa_select(a["feat"], a["pos"], a["ctr"], a["w1"], a["wp"], a["ab1"], a["w2"],
                  a["ab2"], 0.2, 32, selection="nearest")
    idx, mask = ball_query_knn(a["pos"], a["ctr"], 0.2, 32)
    with pytest.raises(ValueError, match="idx"):
        cuda_pointconv.sa_gather_cuda(a["feat"], a["ctr"], idx, mask, a["w1"], a["wp"],
                                      a["ab1"], a["w2"], a["ab2"])   # int64 idx


FIRST_CASES = ["clusters", "voxel", "ragged_s", "one_cloud", "groups"]


def _first_args(rng, dev, dtype, case, n, p, s, c, h1, h2, radius, k=32):
    """The "first" level's arguments for one case: "clusters": random points,
    duplicates, a line of K + 3 points whose first K lie within radius of
    center 0 and all of them within radius of center 1; "voxel": points and
    centers on a 1/16 grid, many exactly at r = 4/16; "ragged_s": clusters
    with S - 5 centers (no tile size divides it); "one_cloud": clusters with
    N = 1; "groups": clusters with 293 centers (three groups of selection;
    past the first, centers drawn from the points). Center 5 of cloud 0 has
    no point in radius."""
    if case == "voxel":
        radius = 0.25
        pos = torch.from_numpy((rng.integers(-8, 9, (n, p, 3)) / 16.0).astype(np.float32))
        ctr = pos[:, :s].clone()
    else:
        n = 1 if case == "one_cloud" else n
        s = {"ragged_s": s - 5, "groups": 293}.get(case, s)
        pos = torch.from_numpy((rng.random((n, p, 3)) - 0.5).astype(np.float32))
        pos[:, 10:15] = pos[:, 0:5]
        step = radius / (k - 0.5)
        pos[:, p - k - 3:] = 2.0
        pos[:, p - k - 3:, 0] += step * torch.arange(k + 3, dtype=torch.float32)
        ctr = pos[:, torch.from_numpy(rng.integers(0, p, s))] if s > p else pos[:, :s].clone()
        ctr[:, 0] = 2.0
        ctr[:, 1] = torch.tensor([2.0 + step * ((k + 2) // 2), 2.0, 2.0])
    ctr[0, 5] = 9.0
    pos, ctr = pos.to(dev).contiguous(), ctr.to(dev).contiguous()
    x = _randn(rng, (n, p, c - 3), dev).to(dtype)
    feat = torch.cat([x, pos.to(dtype)], -1).contiguous()
    w1 = _randn(rng, (c, h1), dev, c ** -0.5).to(dtype)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5).to(dtype)
    ab1 = torch.stack([_randn(rng, h1, dev, 0.1, 1.0), _randn(rng, h1, dev, 0.1)])
    ab2 = torch.stack([_randn(rng, h2, dev, 0.1, 1.0), _randn(rng, h2, dev, 0.1)])
    return (feat, pos, ctr, w1, w1[c - 3:].contiguous(), ab1, w2, ab2, radius, k)


def _check_first(args, dtype):
    before = cuda_pointconv.KERNEL_FIRST.launches
    got = sa_select(*args)
    assert cuda_pointconv.KERNEL_FIRST.launches == before + 1
    _close(got, sa_select_plain(*args), dtype)
    assert (got[0, 5] == 0).all()
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("case", FIRST_CASES)
def test_sa_select_first_kernel_cases(dev, dtype, shape, case):
    _check_first(_first_args(np.random.default_rng(12), dev, dtype, case, *shape), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sa_select_first_kernel_wide_output(dev, dtype):
    args = _first_args(np.random.default_rng(13), dev, dtype, "clusters",
                       5, 64, 32, 131, 256, 512, 0.4)
    assert cuda_pointconv.tile_plan(64, 32, 131, 256, 512, 32, dtype).slices == 2
    _check_first(args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sa_select_first_kernel_takes_no_clouds(dev, dtype):
    args = _first_args(np.random.default_rng(14), dev, dtype, "clusters",
                       1, 128, 64, 67, 128, 128, 0.3)
    args = tuple(a[:0].contiguous() if i < 3 else a for i, a in enumerate(args))
    before = cuda_pointconv.KERNEL_FIRST.launches
    got = sa_select(*args)
    assert cuda_pointconv.KERNEL_FIRST.launches == before
    assert got.shape == (0, 64, 128) and got.dtype == dtype


def _check_bisect_exact(args, dtype, selection):
    """A _first_args case through "bisect" (sa_select, 12 rounds) or "exact"
    (set_abstraction with select_k, x and Wx without the position columns):
    one launch of its kernel, the plain version's output."""
    if selection == "bisect":
        kernel = cuda_pointconv.KERNEL_BISECT
        call = lambda: sa_select(*args, selection="bisect")           # noqa: E731
        plain = lambda: sa_select_plain(*args, selection="bisect")    # noqa: E731
    else:
        feat, pos, ctr, w1, wp, ab1, w2, ab2, radius, k = args
        c = feat.shape[-1] - 3
        sargs = (feat[..., :c].contiguous(), pos, ctr, w1[:c].contiguous(), wp, ab1, w2, ab2,
                 radius, k)
        kernel = cuda_pointconv.KERNEL_EXACT
        call = lambda: set_abstraction(*sargs, select_k=True)         # noqa: E731
        plain = lambda: set_abstraction_plain(*sargs, select_k=True)  # noqa: E731
    before = kernel.launches
    got = call()
    assert kernel.launches == before + 1
    _close(got, plain(), dtype)
    assert (got[0, 5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("case", FIRST_CASES)
@pytest.mark.parametrize("selection", ["bisect", "exact"])
def test_sa_bisect_exact_kernel_cases(dev, dtype, shape, case, selection):
    _check_bisect_exact(_first_args(np.random.default_rng(20), dev, dtype, case, *shape),
                        dtype, selection)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selection", ["bisect", "exact"])
def test_sa_bisect_exact_kernels_take_no_clouds(dev, dtype, selection):
    a = _sa_level_inputs(np.random.default_rng(21), dev, dtype, 1, 128, 64, 67, 128, 128)
    a = {key: v[:0].contiguous() if key in ("x", "feat", "pos", "ctr") else v
         for key, v in a.items()}
    kernel = cuda_pointconv.TILE_KERNELS[selection]
    before = kernel.launches
    if selection == "bisect":
        got = sa_select(a["feat"], a["pos"], a["ctr"], a["w1"], a["wp"], a["ab1"], a["w2"],
                        a["ab2"], 0.3, 32, selection="bisect")
    else:
        got = set_abstraction(a["x"], a["pos"], a["ctr"], a["wx"], a["wp"], a["ab1"],
                              a["w2"], a["ab2"], 0.3, 32, select_k=True)
    assert kernel.launches == before
    assert got.shape == (0, 64, 128) and got.dtype == dtype


PLAN_LEVELS = [(256, 128, 6, 32, 64), (128, 64, 67, 128, 128), (64, 32, 131, 256, 256),
               (64, 32, 131, 256, 512), (64, 300, 131, 256, 256)]


def _assert_tile_plan_is_the_kernels(dtype, selection, p, s, c, h1, h2, k=32):
    """select_smem is the kernel's layout() for every tile layout and budget
    it takes (the largest size_t for the others), and tile_plan's blocks per
    SM the occupancy query's."""
    from text2loc_tpu_torch.ops import _cuda

    lib, code = _cuda.library(), _cuda.DTYPE_CODE[dtype]
    layout = getattr(lib, f"t2l_sa_{selection}_layout")
    budgets = [b for b in cuda_pointconv.ALL_BUDGETS if b >= p] if selection == "all" else [0]
    for rows, resident in cuda_pointconv.TILE_LAYOUTS:
        ok = (16 if selection == "all" else k) <= rows <= cuda_pointconv.max_rows(h1, h2)
        for budget in budgets:
            want = (cuda_pointconv.select_smem(p, s, c, h1, h2, k, rows, resident, dtype,
                                               selection, budget) if ok else 2 ** 64 - 1)
            assert layout(p, s, c, h1, h2, k, rows, resident, budget, code) == want
    if selection == "all":     # a budget below P
        assert layout(p, s, c, h1, h2, k, 64, 0, p - 1, code) == 2 ** 64 - 1
    else:                      # K above 32
        assert layout(p, s, c, h1, h2, 33, 64, 0, 0, code) == 2 ** 64 - 1
    plan = cuda_pointconv.tile_plan(p, s, c, h1, h2, k, dtype, selection)
    occ = ctypes.c_int(0)
    assert getattr(lib, f"t2l_sa_{selection}_occupancy")(
        p, s, c, h1, h2, k, plan.rows, plan.resident, plan.budget, code,
        ctypes.byref(occ)) == 0
    assert occ.value == plan.blocks_per_sm >= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,s,c,h1,h2", PLAN_LEVELS)
def test_sa_select_first_plan_is_the_kernels(dev, dtype, p, s, c, h1, h2):
    _assert_tile_plan_is_the_kernels(dtype, "first", p, s, c, h1, h2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selection", ["gather", "all"])
@pytest.mark.parametrize("p,s,c,h1,h2", PLAN_LEVELS)
def test_sa_gather_all_plans_are_the_kernels(dev, dtype, selection, p, s, c, h1, h2):
    _assert_tile_plan_is_the_kernels(dtype, selection, p, s,
                                     c - 3 if selection == "all" else c, h1, h2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selection", ["bisect", "exact"])
@pytest.mark.parametrize("p,s,c,h1,h2", PLAN_LEVELS)
def test_sa_bisect_exact_plans_are_the_kernels(dev, dtype, selection, p, s, c, h1, h2):
    from text2loc_tpu_torch.ops import _cuda

    c = c - 3 if selection == "exact" else c
    _assert_tile_plan_is_the_kernels(dtype, selection, p, s, c, h1, h2)
    layout = getattr(_cuda.library(), f"t2l_sa_{selection}_layout")
    assert layout(257, s, c, h1, h2, 32, 64, 0, 0, _cuda.DTYPE_CODE[dtype]) == 2 ** 64 - 1


def test_sa_select_first_rejects_what_the_kernel_does_not_take(dev):
    args = list(_first_args(np.random.default_rng(15), dev, torch.float32, "clusters",
                            2, 64, 32, 131, 256, 256, 0.4))
    with pytest.raises(ValueError, match="K=33"):
        sa_select(*args[:9], 33)
    flat = torch.zeros(256 * 256 + 1, device=dev)
    args[6] = flat[1:].view(256, 256)                 # contiguous, 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        sa_select(*args)


ALL_CASES = ["split", "whole", "voxel"]


def _all_args(rng, dev, dtype, case, n, p, s, c, h1, h2, radius):
    """set_abstraction's arguments for one "all" case: "split": random points
    and a dense cluster of 3P/4 of them within 0.01 of point 0, so that
    centers in it hold more edges than the plan's tile where P exceeds it,
    and others straddle a tile's end; "whole": every point within radius of
    every center (S x P edges, several groups a cloud); "voxel": points on
    a 1/16 grid with duplicates, many exactly at r = 4/16. Center 5 of
    cloud 0 has no point in radius."""
    if case == "voxel":
        radius = 0.25
        pos = rng.integers(-8, 9, (n, p, 3)) / 16.0
        pos[:, 10:15] = pos[:, 0:5]
    else:
        pos = rng.random((n, p, 3)) - 0.5
        if case == "split":
            q = 3 * p // 4
            pos[:, 1:q] = pos[:, :1] + 0.01 * (rng.random((n, q - 1, 3)) - 0.5)
        else:
            radius = 4.0
    pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    ctr = pos[:, :s].contiguous()
    ctr[0, 5] = 9.0
    x = _randn(rng, (n, p, c - 3), dev).to(dtype).contiguous()
    wx = _randn(rng, (c - 3, h1), dev, c ** -0.5).to(dtype)
    wp = _randn(rng, (3, h1), dev, c ** -0.5).to(dtype)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5).to(dtype)
    ab1 = torch.stack([_randn(rng, h1, dev, 0.1, 1.0), _randn(rng, h1, dev, 0.1)])
    ab2 = torch.stack([_randn(rng, h2, dev, 0.1, 1.0), _randn(rng, h2, dev, 0.1)])
    return (x, pos, ctr, wx, wp, ab1, w2, ab2, radius, 32)


def _split_centers(pos, ctr, radius, plan):
    """(centers with more edges than the plan's tile, centers whose edges
    straddle a tile's end) as the "all" kernel cuts groups and tiles."""
    counts = (squared_distances(pos, ctr) <= radius * radius).sum(-1).cpu().tolist()
    over = straddle = 0
    for row in counts:
        for g0, g1 in cuda_pointconv.all_groups(row, plan.budget):
            start = 0
            for cnt in row[g0:g1]:
                if cnt:
                    over += cnt > plan.rows
                    straddle += start // plan.rows != (start + cnt - 1) // plan.rows
                start += cnt
    return over, straddle


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("case", ALL_CASES)
def test_sa_all_kernel_cases(dev, dtype, shape, case):
    n, p, s, c, h1, h2, radius = shape
    args = _all_args(np.random.default_rng(16), dev, dtype, case, n, p, s, c, h1, h2, radius)
    x, pos, ctr, radius = args[0], args[1], args[2], args[8]
    plan = cuda_pointconv.tile_plan(p, s, c - 3, h1, h2, 32, dtype, "all")
    over, straddle = _split_centers(pos, ctr, radius, plan)
    if case == "split":
        assert straddle > 0 and (over > 0 or p <= plan.rows)
    if case == "whole":
        assert len(cuda_pointconv.all_groups([p] * s, plan.budget)) > 1 or p * s <= plan.budget
    before = cuda_pointconv.KERNEL_ALL.launches
    got = set_abstraction(*args, select_k=False)
    assert cuda_pointconv.KERNEL_ALL.launches == before + 1
    _close(got, set_abstraction_plain(*args, select_k=False), dtype)
    assert (got[0, 5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SA_SHAPES)
@pytest.mark.parametrize("approx", [False, True])
def test_sa_gather_kernel_holes_and_duplicates(dev, dtype, shape, approx):
    """Masks with holes in mid-row, a duplicated neighbour in a valid slot
    and all-invalid rows, over the exact and the approximate ball query."""
    rng = np.random.default_rng(17)
    n, p, s, c, h1, h2, radius = shape
    a = _sa_level_inputs(rng, dev, dtype, n, p, s, c, h1, h2, voxel=approx)
    idx, mask = ball_query_knn(a["pos"], a["ctr"], radius, 32, approx=approx)
    idx, mask = idx.to(torch.int32).contiguous(), mask.clone()
    mask[:, :, 3] = False
    mask[:, ::2, 10:13] = False
    idx[:, :, 6] = idx[:, :, 5]
    mask[:, :, 6] = mask[:, :, 5]
    mask[1, :4] = False
    args = (a["feat"], a["ctr"], idx, mask, a["w1"], a["wp"], a["ab1"], a["w2"], a["ab2"])
    before = cuda_pointconv.KERNEL_GATHER.launches
    got = sa_gather(*args)
    assert cuda_pointconv.KERNEL_GATHER.launches == before + 1
    _close(got, sa_gather_plain(*args), dtype)
    assert (got[1, :4] == 0).all() and (got[0, 5] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selection", ["gather", "all"])
def test_sa_gather_all_kernels_take_no_clouds(dev, dtype, selection):
    a = _sa_level_inputs(np.random.default_rng(18), dev, dtype, 1, 128, 64, 67, 128, 128)
    a = {key: v[:0].contiguous() if key in ("x", "feat", "pos", "ctr") else v
         for key, v in a.items()}
    kernel = cuda_pointconv.TILE_KERNELS[selection]
    before = kernel.launches
    if selection == "gather":
        idx = torch.zeros((0, 64, 32), dtype=torch.int32, device=dev)
        got = sa_gather(a["feat"], a["ctr"], idx, idx.bool(), a["w1"], a["wp"], a["ab1"],
                        a["w2"], a["ab2"])
    else:
        got = set_abstraction(a["x"], a["pos"], a["ctr"], a["wx"], a["wp"], a["ab1"],
                              a["w2"], a["ab2"], 0.3, 32, select_k=False)
    assert kernel.launches == before
    assert got.shape == (0, 64, 128) and got.dtype == dtype


def test_sa_gather_all_reject_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(19)
    a = _sa_level_inputs(rng, dev, torch.float32, 1, 4097, 16, 6, 32, 64)
    with pytest.raises(ValueError, match="P=4097"):
        set_abstraction(a["x"], a["pos"], a["ctr"], a["wx"], a["wp"], a["ab1"], a["w2"],
                        a["ab2"], 0.2, 32, select_k=False)
    a = _sa_level_inputs(rng, dev, torch.float32, 2, 64, 16, 6, 32, 64)
    idx = torch.zeros((2, 16, 33), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="K=33"):
        sa_gather(a["feat"], a["ctr"], idx, idx.bool(), a["w1"], a["wp"], a["ab1"],
                  a["w2"], a["ab2"])


def _mha_args(dev, dtype, b, lq, lk, d, self_attn, seed=2):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (b, lq, d), dev).to(dtype)
    kv = x if self_attn else _randn(rng, (b, lk, d), dev).to(dtype)
    mats = [_randn(rng, (d, d), dev, 1 / math.sqrt(d)) for _ in range(4)]
    vecs = [_randn(rng, d, dev, 0.1) for _ in range(4)]
    mask = torch.from_numpy(rng.random((b, lk)) > 0.3).to(dev)
    mask[:, 0] = True
    mask[1] = False                                   # an all-masked sample
    return (x, kv, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2], mats[3],
            vecs[3], _randn(rng, d, dev, 0.1, 1.0), _randn(rng, d, dev, 0.1), mask)


# d <= 256 shapes that the fused block does not take: 48 keys (past its
# 32), and f32 cross-attention of 64 queries over 32 keys at D=256, whose
# one-block layout exceeds a block's shared memory (a cluster of one block
# per head would fit at B = 1, but not at B = 64 on 132 SMs).
TILED_TO_D256 = {(48, 48, 128, torch.bfloat16), (48, 48, 128, torch.float32),
                 (64, 32, 256, torch.float32)}


@pytest.mark.parametrize("dtype,b,lq,lk,d,self_attn", [
    (dt, *case) for dt in DTYPES for case in ((33, 16, 6, 128, False),
                                              (9, 28, 28, 256, True),
                                              (5, 16, 16, 1024, True),
                                              (9, 48, 48, 128, True),
                                              (64, 64, 32, 256, False))
] + [(torch.bfloat16, 37, 16, 16, 1024, True),    # M = 592: the small GEMM tile
     (torch.bfloat16, 7, 16, 6, 512, False),      # cross-attention above d=256
     (torch.bfloat16, 3, 13, 13, 1024, True),     # M = 39: rows past M in a tile
     (torch.float32, 3, 13, 5, 512, False)]
   + [(dt, *case) for dt in DTYPES for case in ((2, 128, 128, 1024, True),    # key-tiled core
                                                (3, 16, 600, 1024, False))])
def test_mha_kernel(dev, dtype, b, lq, lk, d, self_attn):
    """The fused kernel to d=256 where it takes the shape, the tiled chain
    above and where it does not (bf16 and f32), each counting one launch
    per block."""
    args = _mha_args(dev, dtype, b, lq, lk, d, self_attn)
    routed = cuda_mha.route(lq, lk, d, 4, dtype, self_attn=self_attn)
    assert routed == ("fused" if d <= 256 and (lq, lk, d, dtype) not in TILED_TO_D256
                      else "tiled")
    kernel, other = ((cuda_mha.KERNEL, cuda_mha.KERNEL_TILED) if routed == "fused"
                     else (cuda_mha.KERNEL_TILED, cuda_mha.KERNEL))
    before, before_other = kernel.launches, other.launches
    got = mha_addln(*args, num_heads=4)
    assert kernel.launches == before + 1 and other.launches == before_other
    _close(got, mha_addln_plain(*args, num_heads=4), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,lq,lk,d,self_attn", [(37, 16, 16, 1024, True),
                                                 (7, 16, 6, 512, False),
                                                 (1584, 16, 16, 1024, True),
                                                 (2, 128, 128, 1024, True),
                                                 (3, 16, 600, 1024, False)])
def test_mha_tiled_stages(dev, dtype, b, lq, lk, d, self_attn):
    """Each stage of the tiled chain alone against its plain stage, on the
    plain stage's inputs: the projection GEMM(s), the attention core, the
    out-projection GEMM with the residual and the LayerNorm. The stage
    entry points launch no counted block."""
    x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = _mha_args(
        dev, dtype, b, lq, lk, d, self_attn, seed=4)
    before = cuda_mha.KERNEL_TILED.launches
    got = cuda_mha.tiled_project_cuda(x, kv, wq, bq, wk, bk, wv, bv, num_heads=4)
    want = mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, num_heads=4)
    for a, w in zip(got, want):
        _close(a, w, dtype)
    q, k, v = want
    _close(cuda_mha.tiled_core_cuda(q, k, v, mask, num_heads=4),
           mha_core_plain(q, k, v, mask, num_heads=4), dtype)
    o = mha_core_plain(q, k, v, mask, num_heads=4)
    _close(cuda_mha.tiled_out_addln_cuda(x, o, wo, bo, g, be),
           mha_out_addln_plain(x, o, wo, bo, g, be), dtype)
    assert cuda_mha.KERNEL_TILED.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_route_layout_is_the_kernels(dev, dtype):
    """The shared bytes of fused_plan's layouts equal t2l_mha_addln_layout's
    for every G and cluster the kernel takes, and the kernel refuses (0)
    where they exceed a block's shared memory; at every B the plan of a
    fused route is one the kernel takes; the core layout that core_layout
    plans has t2l_mha_tiled_core_smem's shared bytes, the one-block core's
    and the key-tiled core's alike, and the kernels refuse the one-block
    core where core_layout takes the key-tiled one."""
    from text2loc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    code, t = _cuda.DTYPE_CODE[dtype], 2 if dtype == torch.bfloat16 else 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for lq, lk, d, self_attn in [(16, 6, 128, False), (6, 16, 128, False), (16, 16, 128, True),
                                 (28, 28, 256, True), (5, 3, 256, False), (64, 64, 256, True),
                                 (6, 6, 256, True), (64, 32, 256, False), (33, 40, 128, False)]:
        for g in range(1, 80 // max(lq, lk) + 1):
            for c in (1, 4):
                want = cuda_mha._fused_layout(g, c, lq, lk, d, self_attn, t).smem
                got = lib.t2l_mha_addln_layout(g, c, lq, lk, d, 4, int(self_attn), code)
                takes = lk <= cuda_mha.FUSED_MAX_KEYS and want <= _cuda.SMEM_LIMIT
                assert got == (want if takes else 0)
        for b in (0, 1, 10, 33, 34, 64, 263, 264, 640, 641, 5000):
            plan = cuda_mha.fused_plan(b, lq, lk, d, 4, dtype, self_attn=self_attn, sms=sms)
            if cuda_mha.route(lq, lk, d, 4, dtype, self_attn=self_attn) == "fused":
                assert plan.smem == lib.t2l_mha_addln_layout(
                    plan.samples, plan.cluster, lq, lk, d, 4, int(self_attn), code) > 0
            else:
                assert plan is None
        assert_core_layout_is_the_kernels(lib, lq, lk, d, 4, dtype)
    for lq, lk, d, heads in [(16, 16, 1024, 4), (116, 116, 1024, 4), (117, 117, 1024, 4),
                             (128, 128, 1024, 4), (16, 600, 1024, 4), (69, 69, 1024, 4),
                             (70, 70, 1024, 4), (512, 512, 1024, 1), (64, 64, 1280, 1)]:
        assert_core_layout_is_the_kernels(lib, lq, lk, d, heads, dtype)


def assert_core_layout_is_the_kernels(lib, lq, lk, d, heads, dtype):
    """The kernels take cuda_mha.core_layout's plan with its shared bytes
    (t2l_mha_tiled_core_smem); they refuse (0) the one-block core where the
    plan is key-tiled, and the smallest key tile where no plan fits."""
    from text2loc_tpu_torch.ops import _cuda

    code = _cuda.DTYPE_CODE[dtype]
    want = cuda_mha.core_layout(lq, lk, d, heads, dtype)
    if want is None:
        assert lib.t2l_mha_tiled_core_smem(lq, lk, d, heads, *cuda_mha.KEY_TILES[-1], code) == 0
        return
    assert want.smem == lib.t2l_mha_tiled_core_smem(lq, lk, d, heads, want.rows, want.chunk,
                                                    code)
    assert (want.kind == "block") == (want.rows == 0)
    if want.kind == "keys":
        assert lib.t2l_mha_tiled_core_smem(lq, lk, d, heads, 0, 0, code) == 0


# (Lq, Lk, D, self-attention) of the smoke's fused cases, and the B of a
# block's sample count G at B = 640 (G - 1, G + 1), a last block holding
# one sample (641), and a request's B = 1.
FUSED_SHAPES = [(16, 16, 128, True), (16, 6, 128, False), (6, 16, 128, False),
                (6, 6, 128, True), (28, 28, 256, True), (6, 6, 256, True)]


def _fused_batches(lq, lk, d, self_attn, dtype):
    g = cuda_mha.fused_plan(640, lq, lk, d, 4, dtype, self_attn=self_attn,
                            sms=torch.cuda.get_device_properties(0).multi_processor_count).samples
    return sorted({1, max(g - 1, 1), g + 1, 640, 641})


def _fused_args(dev, dtype, b, lq, lk, d, self_attn, masked, seed=5):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (b, lq, d), dev).to(dtype)
    kv = x if self_attn else _randn(rng, (b, lk, d), dev).to(dtype)
    mats = [_randn(rng, (d, d), dev, 1 / math.sqrt(d)) for _ in range(4)]
    vecs = [_randn(rng, d, dev, 0.1) for _ in range(4)]
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((b, lk)) > 0.3).to(dev)
        mask[:, 0] = True
        mask[b // 2] = False                          # an all-masked sample
    return (x, kv, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2], mats[3],
            vecs[3], _randn(rng, d, dev, 0.1, 1.0), _randn(rng, d, dev, 0.1), mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lq,lk,d,self_attn", FUSED_SHAPES)
def test_mha_fused_kernel_batches(dev, lq, lk, d, self_attn, dtype, masked):
    """The fused kernel against the plain version at B = 1, G - 1, G + 1,
    640 and 641 (a last block with one sample), with key_mask None or with
    an all-masked sample; one counted launch per call."""
    for b in _fused_batches(lq, lk, d, self_attn, dtype):
        args = _fused_args(dev, dtype, b, lq, lk, d, self_attn, masked)
        before = cuda_mha.KERNEL.launches
        got = mha_addln(*args, num_heads=4)
        assert cuda_mha.KERNEL.launches == before + 1
        _close(got, mha_addln_plain(*args, num_heads=4), dtype)


@pytest.mark.parametrize("lq,lk,d,self_attn", FUSED_SHAPES)
def test_mha_fused_reads_f32_weights_as_cast_ones(dev, lq, lk, d, self_attn):
    """bf16 activations with the f32 weights give the same bits as the call
    with the weights cast to bf16 beforehand: the kernel rounds them as
    Tensor.to does."""
    for b in (1, 37, 640):
        args = list(_fused_args(dev, torch.bfloat16, b, lq, lk, d, self_attn, True))
        got = mha_addln(*args, num_heads=4)
        for i in (2, 4, 6, 8):
            args[i] = args[i].to(torch.bfloat16)
        assert torch.equal(got, mha_addln(*args, num_heads=4))


# torch.profiler on the card at times drops device events from a window
# (an empty window, or fewer device ops than the kernel's launch counter
# says ran), and in some processes does so in every window. Such a window
# is taken again, up to PROFILER_WINDOWS times. The CUDA runtime calls
# that issue device work (kernel launches, copies, sets), which the
# profiler records on the host, are counted too: every device op is issued
# by one, so a call that issues extra device ops still fails its test
# whichever record lost events.
PROFILER_WINDOWS = 5


def _profiled_device_ops(fn, kernel):
    """(device op names, runtime calls issuing device work, launches of
    `kernel`) of one fn() under torch.profiler, retrying windows that lost
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        before = kernel.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = kernel.launches - before
        events = prof.events()
        ops = [e.name for e in events if e.device_type == DeviceType.CUDA]
        issued = [e.name for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith(("cuda", "cu"))
                  and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))]
        if len(ops) >= launched:
            break
    return ops, issued, launched


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_fused_call_is_one_device_op(dev, dtype):
    """A fused call on the serve's operands (activations in the dtype, f32
    parameters, a bool mask) issues one device op, the kernel, and counts
    one launch; so does a call without a mask."""
    for lq, lk, d, self_attn in FUSED_SHAPES:
        for masked in (True, False):
            args = _fused_args(dev, dtype, 10, lq, lk, d, self_attn, masked)
            mha_addln(*args, num_heads=4)
            torch.cuda.synchronize()
            ops, issued, launched = _profiled_device_ops(
                lambda: mha_addln(*args, num_heads=4), cuda_mha.KERNEL)
            assert launched == 1 and len(issued) == 1, issued
            assert len(ops) <= 1 and all("mha_addln_kernel" in op for op in ops), ops


def _ffn_args(dev, dtype, rows, d, f, seed=3):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (rows, d), dev).to(dtype), _randn(rng, (d, f), dev, d ** -0.5),
            _randn(rng, f, dev, 0.1), _randn(rng, (f, d), dev, f ** -0.5),
            _randn(rng, d, dev, 0.1), _randn(rng, d, dev, 0.1, 1.0),
            _randn(rng, d, dev, 0.1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,f", [(37, 128, 512), (1030, 256, 1024),
                                      (592, 1024, 4096),   # the small GEMM tile
                                      (39, 1024, 4096),    # rows past M in a tile
                                      (23, 512, 2048)])
def test_ffn_kernel(dev, dtype, rows, d, f):
    """The fused kernel to d=256, the tiled chain above (bf16 and f32),
    each counting one launch per block."""
    args = _ffn_args(dev, dtype, rows, d, f)
    routed = cuda_ffn.route(d, f, dtype)
    assert routed == ("fused" if d <= 256 else "tiled")
    kernel, other = ((cuda_ffn.KERNEL, cuda_ffn.KERNEL_TILED) if routed == "fused"
                     else (cuda_ffn.KERNEL_TILED, cuda_ffn.KERNEL))
    before, before_other = kernel.launches, other.launches
    got = ffn_addln(*args)
    assert kernel.launches == before + 1 and other.launches == before_other
    _close(got, ffn_addln_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,f", [(592, 1024, 4096), (39, 1024, 4096),
                                      (25344, 1024, 4096)])
def test_ffn_tiled_stages(dev, dtype, rows, d, f):
    """Each stage of the tiled chain alone against its plain stage, on the
    plain stage's inputs: the hidden GEMM with the relu epilogue, then the
    residual GEMM (K = F) and the LayerNorm. The stage entry points launch
    no counted block."""
    x, w1, b1, w2, b2, g, be = _ffn_args(dev, dtype, rows, d, f, seed=4)
    before = (cuda_ffn.KERNEL_TILED.launches, cuda_mha.KERNEL_TILED.launches)
    _close(cuda_ffn.tiled_hidden_cuda(x, w1, b1), ffn_hidden_plain(x, w1, b1), dtype)
    h = ffn_hidden_plain(x, w1, b1)
    _close(cuda_mha.tiled_out_addln_cuda(x, h, w2, b2, g, be),
           ffn_out_addln_plain(h, x, w2, b2, g, be), dtype)
    assert (cuda_ffn.KERNEL_TILED.launches, cuda_mha.KERNEL_TILED.launches) == before


def test_ffn_route_layout_is_the_kernels(dev):
    """fused_smem's Python sum of the fused layout equals
    t2l_ffn_addln_layout's for every tile and cluster the kernel takes, and
    the kernel refuses (0) a plan past its limits (D > 256, a tile past 80
    rows, a cluster not 1, 2, 4, 8 or 16 or one that does not split F into
    multiples of 16) or past a block's shared memory; at every row count
    the plan of a fused route is one the kernel takes."""
    from text2loc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in DTYPES:
        code = _cuda.DTYPE_CODE[dtype]
        for d, f in [(128, 512), (256, 512), (256, 1024), (1024, 4096), (256, 8192),
                     (128, 1024), (64, 96)]:
            for tile in (16, 32, 48, 64, 80, 96):
                for c in (1, 2, 3, 4, 8, 16, 32):
                    want = cuda_ffn.fused_smem(d, f, dtype, tile, c)
                    takes = (d <= cuda_ffn.FUSED_MAX_D and tile <= cuda_ffn.FUSED_MAX_ROWS
                             and c in (1, 2, 4, 8, 16) and f % (16 * c) == 0
                             and d % (8 * c) == 0
                             and want <= _cuda.SMEM_LIMIT)
                    assert lib.t2l_ffn_addln_layout(tile, c, d, f, code) == (want if takes
                                                                              else 0)
            for rows in (0, 1, 6, 60, 160, 384, 1792, 2113, 10240, 25344):
                plan = cuda_ffn.fused_plan(rows, d, f, dtype, sms=sms)
                if cuda_ffn.route(d, f, dtype) == "fused":
                    assert plan.smem == lib.t2l_ffn_addln_layout(plan.rows, plan.cluster, d, f,
                                                                 code) > 0
                else:
                    assert plan is None


# (D, F) of the fused route's shapes in Config(): the CCT (D=128), obj_inter
# and the coarse inter head (D=256); and row counts whose plans take
# clusters of 16, 8, 4 and 2 blocks and one block a tile on a 132-SM card:
# one row, a batch-1 request's 6, 60 and 160, counts off the multiples of
# the tile, the smoke's 384, 1792 and 10,240.
FFN_FUSED_SHAPES = [(128, 512), (256, 512), (256, 1024)]
FFN_FUSED_ROWS = [1, 6, 17, 60, 160, 384, 1030, 1792, 2113, 3000, 10240]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,f", FFN_FUSED_SHAPES)
def test_ffn_fused_kernel_plans(dev, dtype, d, f):
    """The fused kernel against the plain version at each plan fused_plan
    picks over FFN_FUSED_ROWS, with f32 weights as the model passes them;
    one counted launch per call; the rows cover clusters of 16, 8, 4 and 2
    blocks at each shape (and of 1 at some: test_fused_plan_invariants)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = set()
    for rows in FFN_FUSED_ROWS:
        args = _ffn_args(dev, dtype, rows, d, f)
        clusters.add(cuda_ffn.fused_plan(rows, d, f, dtype, sms=sms).cluster)
        before = cuda_ffn.KERNEL.launches
        got = ffn_addln(*args)
        assert cuda_ffn.KERNEL.launches == before + 1
        _close(got, ffn_addln_plain(*args), dtype)
    if sms == 132:
        assert {2, 4, 8, 16} <= clusters, clusters


@pytest.mark.parametrize("d,f", FFN_FUSED_SHAPES)
def test_ffn_fused_reads_f32_weights_as_cast_ones(dev, d, f):
    """bf16 activations with the f32 weights give the same bits as the call
    with the weights cast to bf16 beforehand: the kernel rounds them as
    Tensor.to does; f32 activations with f32 weights match plain."""
    for rows in (1, 160, 1792, 10240):
        args = list(_ffn_args(dev, torch.bfloat16, rows, d, f))
        got = ffn_addln(*args)
        for i in (1, 3):
            args[i] = args[i].to(torch.bfloat16)
        assert torch.equal(got, ffn_addln(*args))
        _close(got, ffn_addln_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_fused_call_is_one_device_op(dev, dtype):
    """A fused call on the serve's operands (activations in the dtype, f32
    parameters) issues one device op, the kernel, and counts one launch, at
    every cluster size: three calls under torch.profiler give three device
    ops, each the kernel, issued by three runtime calls
    (_profiled_device_ops)."""
    for d, f in FFN_FUSED_SHAPES:
        for rows in (6, 160, 1792, 10240):
            args = _ffn_args(dev, dtype, rows, d, f)
            ffn_addln(*args)
            torch.cuda.synchronize()
            ops, issued, launched = _profiled_device_ops(
                lambda: [ffn_addln(*args) for _ in range(3)], cuda_ffn.KERNEL)
            assert launched == 3 and len(issued) == 3, issued
            assert len(ops) <= 3 and all("ffn_addln_kernel" in op for op in ops), ops


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    pts = torch.rand(4, 32, 3, device=dev)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.double(), 8)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.transpose(0, 1), 8)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.cpu(), 8)
    # f32 at d=1024 (a fused block too big for shared memory) runs the tiled
    # chain, a long sample too (the key-tiled core); a head too wide for the
    # key-tiled core's smallest tile in shared memory is refused.
    x = torch.rand(2, 16, 1024, device=dev)
    kv = torch.rand(2, 16, 1024, device=dev)
    w = torch.rand(1024, 1024, device=dev) / 32
    v = torch.rand(1024, device=dev)
    args = (x, kv, w, v, w, v, w, v, w, v, v, v)
    _close(cuda_mha.mha_addln_cuda(*args, num_heads=4),
           mha_addln_plain(*args, num_heads=4), torch.float32)
    long_kv = torch.rand(2, 512, 1024, device=dev)
    args = (x, long_kv, w, v, w, v, w, v, w, v, v, v)
    _close(cuda_mha.mha_addln_cuda(*args, num_heads=4),
           mha_addln_plain(*args, num_heads=4), torch.float32)
    wide = torch.rand(1, 16, 1280, device=dev)
    w = torch.rand(1280, 1280, device=dev) / 36
    v = torch.rand(1280, device=dev)
    with pytest.raises(ValueError, match="232448"):
        cuda_mha.mha_addln_cuda(wide, wide, w, v, w, v, w, v, w, v, v, v, num_heads=1)
    # The feed-forward block: f32 at D=1024 runs the chain; off the 128 grid
    # above d=256 it is refused, and the fused kernel refuses a layout
    # beyond a block's shared memory.
    args = _ffn_args(dev, torch.float32, 16, 1024, 4096)
    _close(cuda_ffn.ffn_addln_cuda(*args), ffn_addln_plain(*args), torch.float32)
    with pytest.raises(ValueError, match="232448"):
        cuda_ffn.fused_block_cuda(*args)
    with pytest.raises(ValueError, match="multiples of 128"):
        cuda_ffn.ffn_addln_cuda(*_ffn_args(dev, torch.bfloat16, 16, 320, 1280))


def _sa_train_inputs(rng, dev, n, p, s, k, h1, h2):
    u = _randn(rng, (n, p, h1), dev)
    sv = _randn(rng, (n, s, h1), dev, 0.5)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5)
    vecs = [_randn(rng, h, dev, 0.1, mean) for h, mean in
            ((h2, 0.0), (h1, 1.0), (h1, 0.0), (h2, 1.0), (h2, 0.0))]
    idx = torch.from_numpy(rng.integers(0, p, (n, s, k)).astype(np.int32)).to(dev)
    maskm = torch.from_numpy(rng.random((n, s, k)) < 0.7).to(dev)
    maskm[0, 0] = False                               # a row without valid slots
    maskm[1 % n] = False                              # a cloud without a valid edge
    maskf = maskm.clone()
    maskf[-1] = False                                 # an object out of the statistics
    return (u, sv, w2, *vecs, idx, maskm, maskf)


# (n, p, s, k, h1, h2): the coarse step's three level widths; K < 32 with
# H1 > H2; K = 64 (one center fills a tile); more clouds than the
# backward's persistent grid has blocks; widths that are not powers of two;
# K = 1. Every tile but a level's last can end ragged (whole centers only).
SA_TRAIN_SHAPES = [(20, 256, 128, 32, 32, 64), (9, 128, 64, 32, 128, 128),
                   (7, 64, 32, 32, 256, 256), (5, 40, 12, 5, 64, 32),
                   (3, 96, 48, 64, 64, 128), (600, 32, 16, 16, 32, 32),
                   (4, 64, 24, 16, 96, 160), (6, 48, 20, 1, 32, 32)]


def _assert_grads_close(got, want, dtype):
    floor = 1e-3 * max(w.norm().item() for w in want)
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all()
        rel = ((g - w).norm() / max(w.norm().item(), floor)).item()
        assert rel <= REL_L2[dtype], rel


def _check_sa_train(dev, dtype, n, p, s, k, h1, h2, cache_dtype=None):
    """The level's forward, statistics and gradients on the card against
    the plain forward and the hand-derived plain backward (at the plain
    forward's statistics), dout zero at the near-ties of either forward's
    statistics."""
    rng = np.random.default_rng(4)
    args = _sa_train_inputs(rng, dev, n, p, s, k, h1, h2)
    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf = args
    dout = _randn(rng, (n, s, h2), dev)
    want_out, want_stats, aux1, aux2 = _forward_plain(*args, 1e-5, dtype, cache_dtype)
    level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dtype, cache_dtype)
    _, _, kaux1, kaux2 = forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5)
    ties = (near_ties(u, sv, w2, idx, maskm, aux1, aux2, dtype, cache_dtype)
            | near_ties(u, sv, w2, idx, maskm, kaux1, kaux2, dtype, cache_dtype))
    dout = dout.masked_fill(ties, 0.0)
    diff = [a.clone().requires_grad_() for a in args[:8]]
    fwd, bwd = ((cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD) if cache_dtype is None
                else (cuda_sa_train.KERNEL_E_FWD, cuda_sa_train.KERNEL_E_BWD))
    before = (fwd.launches, bwd.launches)
    out, stats = sa_train(*diff, *args[8:], compute_dtype=dtype, cache_dtype=cache_dtype)
    (out * dout).sum().backward()
    assert fwd.launches > before[0]
    assert bwd.launches > before[1]
    _close(out, want_out, dtype)
    for g, w in zip(stats, want_stats):
        _close(g, w, dtype)
    assert (out[0, 0] == 0).all()
    want = sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1, aux2, want_stats[4],
                                   dout, dtype, cache_dtype)
    _assert_grads_close([d.grad for d in diff], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,s,k,h1,h2", SA_TRAIN_SHAPES)
def test_sa_train_kernels(dev, dtype, n, p, s, k, h1, h2):
    _check_sa_train(dev, dtype, n, p, s, k, h1, h2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,s,k,h1,h2", SA_TRAIN_SHAPES)
def test_sa_train_bf16_cache_kernels(dev, dtype, n, p, s, k, h1, h2):
    """The kernels of the token "e": e rounded to bf16 in every pass."""
    _check_sa_train(dev, dtype, n, p, s, k, h1, h2, cache_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,resident",
                         [(128, 1), (128, 0), (64, 1), (64, 0), (32, 1), (32, 0)])
@pytest.mark.parametrize("cache_dtype", [None, torch.bfloat16])
def test_sa_train_bwd_layouts(dev, dtype, rows, resident, cache_dtype):
    """Each backward tile layout (tile height, W2 resident in shared memory
    or streamed through the ring) against the plain backward, the forward's
    aux rows given; a pass that the layout does not fit takes the usual
    choice."""
    rng = np.random.default_rng(5)
    n, p, s, k, h1, h2 = 9, 128, 64, 32, 128, 128
    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf = _sa_train_inputs(rng, dev, n, p, s,
                                                                          k, h1, h2)
    dout = _randn(rng, (n, s, h2), dev)
    level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dtype, cache_dtype)
    level.bwd_layouts = ((rows, resident),)
    _, stats, aux1, aux2 = forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5)
    dout = dout.masked_fill(near_ties(u, sv, w2, idx, maskm, aux1, aux2, dtype, cache_dtype),
                            0.0)
    got = backward_cuda(level, aux1, aux2, stats[4], dout)
    want = sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1, aux2, stats[4], dout,
                                   dtype, cache_dtype)
    assert any(level.bwd_plan(pid)[:2] == (rows, resident) for pid in (1, 2, 3))
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,resident", list(cuda_sa_train.LAYOUTS))
@pytest.mark.parametrize("cache_dtype", [None, torch.bfloat16])
def test_sa_train_fwd_layouts(dev, dtype, rows, resident, cache_dtype):
    """Each forward tile layout of the two passes that form z (tile height,
    W2 resident in shared memory or streamed through the ring) against the
    plain forward: output and statistics. K = 16 admits every tile height;
    both passes fit every layout at H = 128."""
    rng = np.random.default_rng(10)
    n, p, s, k, h1, h2 = 9, 128, 64, 16, 128, 128
    args = _sa_train_inputs(rng, dev, n, p, s, k, h1, h2)
    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf = args
    level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dtype, cache_dtype)
    level.fwd_layouts = ((rows, resident),)
    out, stats, _, _ = forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5)
    assert all(level.fwd_plan(pid)[:2] == (rows, resident) for pid in (2, 3))
    assert level.fwd_plan(1)[:3] == (0, 0, 0)
    want_out, want_stats = sa_train_plain(*args, compute_dtype=dtype, cache_dtype=cache_dtype)
    _close(out, want_out, dtype)
    for g, w in zip(stats, want_stats):
        _close(g, w, dtype)


@pytest.mark.parametrize("cache_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("n,p,s,k,h1,h2", SA_TRAIN_SHAPES[:3])
def test_sa_train_plan_is_the_occupancy_querys(dev, n, p, s, k, h1, h2, cache_dtype):
    """Each pass's plan, forward and backward, is the layout the rule picks
    from the C side's shared-memory sizes and occupancy queries: the most
    tile rows in flight on an SM, then the most blocks per SM, then the
    first in LAYOUTS order; and the grid is the blocks one wave holds."""
    import ctypes

    from text2loc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    rng = np.random.default_rng(11)
    u, sv, w2, _, _, _, _, _, idx, maskm, maskf = _sa_train_inputs(rng, dev, n, p, s, k, h1,
                                                                   h2)
    for dtype in DTYPES:
        level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dtype, cache_dtype)
        for direction, sym, plan, blocks in (("fwd", level.sym_fwd, level.fwd_plan,
                                              level.fwd_blocks),
                                             ("bwd", level.sym_bwd, level.bwd_plan,
                                              level.bwd_blocks)):
            for pid in (1, 2, 3):
                layouts = ((0, 0),) if (direction, pid) == ("fwd", 1) else cuda_sa_train.LAYOUTS
                best = None
                for rows, resident in layouts:
                    if rows and rows < k:
                        continue
                    smem = getattr(lib, f"t2l_sa_train_{direction}_smem")(
                        pid, p, h1, h2, rows, resident, level.dtype_code)
                    if smem > _cuda.SMEM_LIMIT:
                        continue
                    occ = ctypes.c_int(0)
                    assert getattr(lib, sym + "_occupancy")(
                        pid, p, k, h1, h2, rows, resident, level.dtype_code,
                        ctypes.byref(occ)) == 0
                    key = (rows * occ.value, occ.value)
                    if occ.value > 0 and (best is None or key > best[0]):
                        best = (key, (rows, resident, smem, occ.value))
                assert plan(pid) == best[1], (direction, pid, dtype)
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                assert blocks(pid) == max(1, min(n, sms * best[1][3]))


def test_sa_train_fwd_passes_are_bit_equal(dev):
    """Each forward pass run twice gives bit-equal results, in both kernels
    and dtypes, with more clouds than the forward's grid has blocks (each
    block walks several)."""
    rng = np.random.default_rng(8)
    n = 1200
    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf = _sa_train_inputs(
        rng, dev, n, 128, 64, 32, 128, 128)
    for dtype in DTYPES:
        for cache in (None, torch.bfloat16):
            level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dtype, cache)
            assert n > max(level.fwd_blocks(pid) for pid in (1, 2, 3))
            _, _, aux1, aux2 = forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5)
            for run in (lambda: level.stats(1, aux1, aux2), lambda: level.stats(2, aux1, aux2),
                        lambda: level.out(aux1, aux2)):
                assert torch.equal(run(), run())


def test_sa_train_kernels_take_no_clouds(dev):
    """N = 0: the forward gives an empty output and the plain version's
    statistics, the backward empty gradients of the inputs."""
    rng = np.random.default_rng(9)
    n, p, s, k, h1, h2 = 0, 32, 16, 8, 64, 64
    u, sv, w2 = _randn(rng, (n, p, h1), dev), _randn(rng, (n, s, h1), dev), _randn(
        rng, (h1, h2), dev, h1 ** -0.5)
    vecs = [_randn(rng, h, dev, 0.1, mean) for h, mean in
            ((h2, 0.0), (h1, 1.0), (h1, 0.0), (h2, 1.0), (h2, 0.0))]
    idx = torch.zeros((n, s, k), dtype=torch.int32, device=dev)
    mask = torch.zeros((n, s, k), dtype=torch.bool, device=dev)
    args = (u, sv, w2, *vecs, idx, mask, mask)
    for dtype in DTYPES:
        for cache in (None, torch.bfloat16):
            diff = [a.clone().requires_grad_() for a in args[:8]]
            out, stats = sa_train(*diff, *args[8:], compute_dtype=dtype, cache_dtype=cache)
            want_out, want_stats = sa_train_plain(*args, compute_dtype=dtype,
                                                  cache_dtype=cache)
            assert out.shape == want_out.shape == (0, s, h2)
            for g, w in zip(stats, want_stats):
                assert torch.equal(g, w)
            out.sum().backward()
            assert diff[0].grad.shape == (0, p, h1) and diff[1].grad.shape == (0, s, h1)


def test_sa_train_kernels_are_deterministic(dev):
    """Two runs are bit-equal, in f32 and bf16, with more clouds than the
    backward's persistent grid has blocks (each block walks several)."""
    rng = np.random.default_rng(6)
    args = _sa_train_inputs(rng, dev, 300, 128, 64, 32, 128, 128)
    dout = _randn(rng, (300, 64, 128), dev)
    for dtype in DTYPES:
        runs = []
        for _ in range(2):
            diff = [a.clone().requires_grad_() for a in args[:8]]
            out, stats = sa_train(*diff, *args[8:], compute_dtype=dtype)
            (out * dout).sum().backward()
            runs.append([out, *stats] + [d.grad for d in diff])
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_sa_train_bf16_cache_is_deterministic_and_rounds_e(dev):
    rng = np.random.default_rng(7)
    args = _sa_train_inputs(rng, dev, 300, 128, 64, 32, 128, 128)
    for dtype in DTYPES:
        runs = []
        for cache in (torch.bfloat16, torch.bfloat16, None):
            diff = [a.clone().requires_grad_() for a in args[:8]]
            out, _ = sa_train(*diff, *args[8:], compute_dtype=dtype, cache_dtype=cache)
            out.square().sum().backward()
            runs.append([out] + [d.grad for d in diff])
        for a, b in zip(runs[0], runs[1]):
            assert torch.equal(a, b)
        assert not torch.equal(runs[0][0], runs[2][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,rows", [(128, 10241), (256, 1795), (1024, 3001), (512, 7)])
def test_add_ln_kernel(dev, dtype, d, rows):
    rng = np.random.default_rng(d + rows)
    x = _randn(rng, (rows, d), dev, 2.0, 0.3).to(dtype)
    res = _randn(rng, (rows, d), dev).to(dtype)
    scale, bias = _randn(rng, d, dev, 0.1, 1.0), _randn(rng, d, dev, 0.1)
    before = cuda_ln.KERNEL.launches
    got = add_layernorm(x, res, scale, bias)
    assert cuda_ln.KERNEL.launches == before + 1
    want = add_layernorm_plain(x, res, scale, bias)
    assert got.dtype == dtype and got.shape == x.shape
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-6 * want.abs().max().item(), err.max().item()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -8))) - 7)
        assert (err <= ulp).all(), err.max().item()


def test_add_ln_kernel_rejects_what_it_cannot_take(dev):
    x = torch.rand(4, 96, device=dev)
    v = torch.rand(96, device=dev)
    with pytest.raises(ValueError):
        cuda_ln.add_layernorm_cuda(x, x, v, v)
    x = torch.rand(4, 128, device=dev)
    with pytest.raises(ValueError):
        add_layernorm(x, x.to(torch.bfloat16), x[0], x[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,q,c", [(50, 256, 4096, 6), (40, 128, 2048, 67),
                                     (30, 64, 1024, 131), (20, 256, 4096, 32),
                                     (10, 64, 1024, 256), (3, 5, 7, 1)])
def test_gather_rows_kernel_is_bit_equal(dev, dtype, n, p, q, c):
    rng = np.random.default_rng(p + q + c)
    values = _randn(rng, (n, p, c), dev).to(dtype)
    idx = torch.from_numpy(rng.integers(0, p, (n, q)).astype(np.int32)).to(dev)
    before = cuda_gather.KERNEL.launches
    got = gather_rows(values, idx)
    assert cuda_gather.KERNEL.launches == before + 1
    assert torch.equal(got, gather_rows_plain(values, idx))


def _gather_want(values, idx):
    """torch.gather with a zero row for an index outside [0, P)."""
    n, p, c = values.shape
    if p == 0:
        return values.new_zeros((n, idx.shape[1], c))
    want = gather_rows_plain(values, idx.clamp(0, p - 1))
    return want.masked_fill(((idx < 0) | (idx >= p))[..., None], 0)


def _gather_check(values, idx, variant):
    n, p, c = values.shape
    addr = values.data_ptr()
    plan = cuda_gather.gather_plan(n, p, idx.shape[1], c * values.element_size(),
                                   align=min(16, addr & -addr) if addr else 16,
                                   sms=_cuda.sm_count(values.device.index))
    assert (plan.chunk_bytes > 0) == (variant == "staged")
    before = cuda_gather.KERNEL.launches
    got = gather_rows(values, idx)
    assert cuda_gather.KERNEL.launches == before + (1 if got.numel() else 0)
    assert got.shape == (n, idx.shape[1], c) and got.dtype == values.dtype
    assert torch.equal(got, _gather_want(values, idx))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 1), (torch.bfloat16, 3),
                                     (torch.bfloat16, 67), (torch.bfloat16, 131),
                                     (torch.float32, 1), (torch.float32, 6),
                                     (torch.float32, 67)])
@pytest.mark.parametrize("n,p,q", [(7, 128, 2048 + 37), (3, 64, 5), (1, 21, 1), (40, 256, 999)])
def test_gather_rows_kernel_odd_widths(dev, dtype, c, n, p, q):
    """Odd row widths, Q off the chunk, indices -1 and P (zero rows), one
    cloud, and values starting off a 16-byte boundary."""
    rng = np.random.default_rng(n * q + c)
    idx_np = rng.integers(-1, p + 1, (n, q)).astype(np.int32)
    idx_np[0, 0], idx_np[-1, -1] = -1, p
    idx = torch.from_numpy(idx_np).to(dev)
    flat = _randn(rng, (n * p * c + 8,), dev).to(dtype)
    for shift in (0, 1, 3):          # elements past the allocation's start
        _gather_check(flat[shift:shift + n * p * c].view(n, p, c), idx, "staged")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_rows_kernel_empty(dev, dtype):
    values = torch.zeros(4, 16, 8, device=dev, dtype=dtype)
    for q in (0, 5):
        got = gather_rows(values[:0], torch.zeros(0, q, dtype=torch.int32, device=dev))
        assert got.shape == (0, q, 8)
    before = cuda_gather.KERNEL.launches
    assert gather_rows(values, torch.zeros(4, 0, dtype=torch.int32, device=dev)).shape == (4, 0, 8)
    assert cuda_gather.KERNEL.launches == before
    # No points: every index is out of range, every row zero.
    _gather_check(values[:, :0], torch.zeros(4, 9, dtype=torch.int32, device=dev), "staged")


@pytest.mark.parametrize("dtype,c", [(torch.float32, 64), (torch.bfloat16, 67),
                                     (torch.float32, 6)])
def test_gather_rows_kernel_direct_variant(dev, dtype, c):
    """Clouds too large for a block's shared memory: one warp a row."""
    rng = np.random.default_rng(c)
    n, p, q = 3, 1 + _cuda.SMEM_LIMIT // (c * 2), 3000
    idx_np = rng.integers(-1, p + 1, (n, q)).astype(np.int32)
    values = _randn(rng, (n, p, c), dev).to(dtype)
    _gather_check(values, torch.from_numpy(idx_np).to(dev), "direct")


@pytest.mark.parametrize("p,c,es", [(256, 6, 2), (128, 67, 2), (64, 131, 4), (128, 128, 4),
                                    (5, 1, 2), (900, 64, 4)])
def test_gather_plan_is_the_kernels(dev, p, c, es):
    lib = _cuda.library()
    plan = cuda_gather.gather_plan(100, p, 16 * p, c * es)
    assert lib.t2l_gather_rows_smem(p, c * es, plan.chunk_bytes) == plan.smem


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,q,c", [(30, 256, 4096, 32), (20, 128, 2048, 128),
                                     (10, 64, 1024, 256), (40, 256, 4096, 6),
                                     (4, 300, 5000, 3)])
def test_scatter_kernel_matches_the_index_order_sum(dev, dtype, n, p, q, c):
    """Random indices and voxel-like ties: one point takes half of a
    cloud's rows, another cloud points all its rows at one point."""
    rng = np.random.default_rng(q + c)
    g = _randn(rng, (n, q, c), dev).to(dtype)
    idx_np = rng.integers(0, p, (n, q)).astype(np.int32)
    idx_np[0, : q // 2] = 3
    idx_np[-1] = p - 1
    idx = torch.from_numpy(idx_np).to(dev)
    before = cuda_gather.KERNEL_SCATTER.launches
    got = scatter_rows(g, idx, p)
    again = scatter_rows(g, idx, p)
    assert cuda_gather.KERNEL_SCATTER.launches == before + 2
    assert torch.equal(got, again)
    want = scatter_rows_plain(g.cpu(), idx.cpu(), p)
    assert got.dtype == dtype and got.shape == (n, p, c)
    got, want = got.float().cpu(), want.float()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    else:
        assert torch.equal(got, want) or ((got - want).abs().max().item()
                                          <= 2 ** -7 * want.abs().max().item())


def test_gather_rows_grad_runs_both_kernels(dev):
    rng = np.random.default_rng(3)
    values = _randn(rng, (8, 64, 16), dev).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 64, (8, 512)).astype(np.int32)).to(dev)
    before = (cuda_gather.KERNEL.launches, cuda_gather.KERNEL_SCATTER.launches)
    out = gather_rows_grad(values, idx)
    out.square().sum().backward()
    assert cuda_gather.KERNEL.launches == before[0] + 1
    assert cuda_gather.KERNEL_SCATTER.launches == before[1] + 1
    plain = values.detach().clone().requires_grad_()
    gather_rows_plain(plain, idx).square().sum().backward()
    assert torch.equal(out, gather_rows_plain(values.detach(), idx))
    err = (values.grad - plain.grad).abs().max().item()
    assert err <= 1e-6 * plain.grad.abs().max().item(), err


# ------------------------------------------------------------ the trainers


def _trainer_setup(pmc=False, full=False):
    """The small test config, or with `full` the default Config's widths
    (the training SA kernels take widths of multiples of 32 only): one
    3-step epoch of batch 8 over 24 poses, a validation split of the same
    cells, and optionally PMC tables over random neighbours."""
    import dataclasses

    from text2loc_tpu_torch.config import Config, small_test_config
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    cfg = Config() if full else small_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=8, epochs=1,
                                                pmc_prob=0.5))
    m = cfg.model
    kw = dict(num_cells=8, object_slots=m.object_size, num_points=m.pointnet.num_points,
              num_mentioned=m.num_mentioned, seed=3)
    scene = make_scene("0003", num_poses=24, **kw)
    if pmc:
        rng = np.random.default_rng(4)
        n = scene.num_poses
        valid = rng.random((n, 8)) < 0.5
        scene = dataclasses.replace(
            scene, cell_neighbors=rng.integers(-1, 8, (8, 8)).astype(np.int32),
            pmc_valid=valid,
            pmc_weight=np.where(valid, rng.uniform(0.5, 4, (n, 8)), 0).astype(np.float32),
            pmc_match=rng.integers(-1, m.object_size, (n, 8, m.num_mentioned)).astype(np.int32))
    val = MultiSceneArrays([make_scene("0003", num_poses=12, pose_seed=9, **kw)])
    emb = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)
    return cfg, MultiSceneArrays([scene]), val, emb


def _nested_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return set(a) == set(b) and all(_nested_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_nested_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_train_fine_on_the_card_checkpoints_and_resumes(dev, tmp_path):
    """train_fine on the card: the training and evaluation kernels launch,
    the best checkpoint restores into a fresh model and optimizer bit for
    bit, and the resumed epoch saves only past the restored best."""
    import dataclasses

    from text2loc_tpu_torch.convert import build_model
    from text2loc_tpu_torch.training import steps
    from text2loc_tpu_torch.training.fine import train_fine
    from text2loc_tpu_torch.utils.checkpoint import CheckpointManager

    cfg, data, val, emb = _trainer_setup(pmc=True, full=True)
    kernels = (cuda_fps.KERNEL, cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD,
               cuda_pointconv.KERNEL_FIRST, cuda_mha.KERNEL, cuda_ffn.KERNEL)
    before = [k.launches for k in kernels]
    best, model, log = train_fine(cfg, data, val, emb, workdir=str(tmp_path), device=dev)
    assert all(k.launches > b for k, b in zip(kernels, before)), [k.name for k in kernels]
    assert np.isfinite(log.history["loss"]).all() and len(log.steps) == 3
    mgr = CheckpointManager(str(tmp_path / "fine_ckpt"), mode="min")
    fresh = build_model(cfg.replace(model=dataclasses.replace(
        cfg.model, dtype=cfg.model.train_dtype)), "fine").to(dev)
    state = steps.TrainState(fresh, steps.make_fine_optimizer(fresh.parameters(), cfg, 3))
    mgr.restore(state)
    assert _nested_equal(mgr.restore(), state.state_dict())
    assert _nested_equal(state.state_dict()["model"], best)
    best_before = mgr.best_metric
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2))
    _, _, log2 = train_fine(cfg2, data, val, emb, workdir=str(tmp_path), resume=True,
                            device=dev)
    assert log2.epochs["loss"] == [1]
    improved = log2.history["val_pose_error"][0] < best_before
    assert (CheckpointManager(str(tmp_path / "fine_ckpt")).latest_step() == 1) == improved


def test_eval_fine_card_equals_cpu(dev):
    """eval_fine of one set of f32 weights in SA mode "first" on the card
    and on the CPU: every position within 1e-2 m (the serve's limit) in
    normalized cell units."""
    import dataclasses

    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.training import steps
    from text2loc_tpu_torch.training.fine import eval_fine

    cfg, _, val, emb = _trainer_setup()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    cpu = init_weights(build_model(cfg, "fine"), torch.Generator().manual_seed(5))
    card = build_model(cfg, "fine").to(dev)
    card.load_state_dict(cpu.state_dict())
    before = cuda_pointconv.KERNEL_FIRST.launches
    batch = val.gather_fine(np.arange(val.num_poses), cfg.model.pad_size)
    got = steps.make_fine_forward(card, emb, cfg)(batch).cpu()
    want = steps.make_fine_forward(cpu, emb, cfg)(batch)
    assert cuda_pointconv.KERNEL_FIRST.launches > before
    limit = 1e-2 / float(val.cell_size[0])
    assert float((got - want).abs().max()) <= limit
    assert abs(eval_fine(val, card, emb, cfg) - eval_fine(val, cpu, emb, cfg)) <= limit


def test_train_coarse_on_the_card_evaluates_and_checkpoints(dev, tmp_path):
    from text2loc_tpu_torch.training.coarse import train_coarse

    cfg, data, val, emb = _trainer_setup(full=True)
    before = cuda_sa_train.KERNEL_BWD.launches
    _, _, log = train_coarse(cfg, data, val, emb, workdir=str(tmp_path), device=dev,
                             eval_train=True)
    assert cuda_sa_train.KERNEL_BWD.launches > before
    assert len(log.history["val_acc"]) == 1 and "train_recall@1" in log.history
    assert (tmp_path / "coarse_ckpt" / "metrics.json").exists()


def test_serve_paths_launch_their_kernels_and_the_cache_skips_pointnet(dev, tmp_path):
    """At the default Config()'s widths: the second build from the cache
    launches no PointNet kernel and serves the first build's results bit for
    bit; the stepwise path's queries launch FPS, the SA level and the
    attention and feed-forward blocks (the E=1024 intra stack among them);
    localize_embedded launches the text trunk's kernels."""
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    cfg = Config()
    m = cfg.model
    data = MultiSceneArrays([make_scene("0005", num_cells=8, num_poses=8,
                                        object_slots=m.object_size,
                                        num_points=m.pointnet.num_points,
                                        num_mentioned=m.num_mentioned, seed=5)])
    gen = torch.Generator().manual_seed(0)
    coarse = init_weights(build_model(cfg, "coarse"), gen)
    fine = init_weights(build_model(cfg, "fine"), gen)
    emb = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)
    path = str(tmp_path / "gallery.npz")

    def make(**kw):
        return Localizer(data, coarse, fine, emb, cfg, top_k=3, device=dev,
                         cache_path=path, **kw)

    q = np.arange(4)
    hints = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    pointnet = (cuda_fps.KERNEL, cuda_pointconv.KERNEL_FIRST)
    first = make()
    before = [k.launches for k in pointnet]
    warm = make()
    assert [k.launches for k in pointnet] == before
    a, b = first.localize(*hints), warm.localize(*hints)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    step = make(precompute_fine=False)
    assert [k.launches for k in pointnet] == before
    kernels = (*pointnet, cuda_mha.KERNEL, cuda_mha.KERNEL_TILED, cuda_ffn.KERNEL)
    before = [k.launches for k in kernels]
    res = step.localize(*hints)
    assert all(k.launches > n for k, n in zip(kernels, before)), [k.name for k in kernels]
    assert np.isfinite(res.candidates_w).all()
    text = emb.to(dev).embed(*hints)
    before = [k.launches for k in kernels]
    res = first.localize_embedded(text.token_embeds.cpu(), text.token_mask.cpu(),
                                  text.sentence_mask.cpu())
    assert [k.launches for k in pointnet] == before[:2]
    assert all(k.launches > n for k, n in zip(kernels[2:], before[2:]))
    assert np.isfinite(res.candidates_w).all()


def test_embedding_tables_cached_serve_equals_the_cpu(dev):
    """class_embed and color_embed at the default Config()'s widths in f32:
    the cached serve on the card gives the CPU's top-1 cells where the
    CPU's top-1/top-2 margin exceeds 1e-4 and positions within 1e-2 m, and
    launches no FPS or SA kernel (no PointNet), the attention and
    feed-forward kernels as usual."""
    import dataclasses

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, class_embed=True, color_embed=True,
                                                dtype="float32"))
    m = cfg.model
    data = MultiSceneArrays([make_scene("0006", num_cells=16, num_poses=8,
                                        object_slots=m.object_size,
                                        num_points=m.pointnet.num_points,
                                        num_mentioned=m.num_mentioned, seed=6)])
    gen = torch.Generator().manual_seed(1)
    coarse = init_weights(build_model(cfg, "coarse"), gen)
    fine = init_weights(build_model(cfg, "fine"), gen)
    emb = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)
    hints = (data.hint_dir, data.hint_color, data.hint_label, data.hint_mask)
    point_kernels = (cuda_fps.KERNEL, *cuda_pointconv.KERNELS, cuda_sa_train.KERNEL_FWD,
                     cuda_sa_train.KERNEL_BWD, cuda_sa_train.KERNEL_E_FWD,
                     cuda_sa_train.KERNEL_E_BWD)
    blocks = (cuda_mha.KERNEL, cuda_ffn.KERNEL)
    before = [k.launches for k in point_kernels + blocks]
    card = Localizer(data, coarse, fine, emb, cfg, top_k=3, device=dev).localize(*hints)
    after = [k.launches for k in point_kernels + blocks]
    n = len(point_kernels)
    assert after[:n] == before[:n], [k.name for k in point_kernels]
    assert all(a > b for a, b in zip(after[n:], before[n:])), [k.name for k in blocks]
    cpu = Localizer(data, coarse.cpu(), fine.cpu(), emb, cfg, top_k=3,
                    device="cpu").localize(*hints)
    margin = cpu.scores[:, 0] - cpu.scores[:, 1]
    clear = margin > 1e-4
    assert clear.any()
    np.testing.assert_array_equal(card.cell_indices[clear, 0], cpu.cell_indices[clear, 0])
    same = card.cell_indices == cpu.cell_indices
    assert np.abs(card.candidates_w - cpu.candidates_w)[same].max() <= 1e-2
