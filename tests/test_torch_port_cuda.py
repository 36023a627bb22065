"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file needs no jax; where jax is not installed, run it without the
suite's conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances: FPS bit-equal; the others at 1e-4 x max|plain| in f32 and
2e-2 x max|plain| in bf16 (sums in another order, bf16 rounding points of
the kernel's own). The training SA level's gradients are held by relative
L2 error (1e-3 f32, 2e-2 bf16): the neighbour max and the ReLUs have
discontinuous backwards, and z differs from the plain version's in the last
bits, so a near-tie can pick another winning edge and move O(1) of gradient
between edges; norms are floored at 1e-3 x the largest gradient norm of the
level, since db2 and the BN shift gradients are near zero by BN shift
invariance (sums of cancelling terms).
"""

import math

import numpy as np
import pytest
import torch

from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_mha, cuda_pointconv,
                                    cuda_sa_train)
from text2loc_tpu_torch.ops.ffn import ffn_addln, ffn_addln_plain
from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain, fps_gather
from text2loc_tpu_torch.ops.mha import mha_addln, mha_addln_plain
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.pointconv import (
    sa_gather,
    sa_gather_plain,
    sa_select,
    sa_select_plain,
    set_abstraction,
    set_abstraction_plain,
)
from text2loc_tpu_torch.ops.sa_train import sa_train, sa_train_backward_plain, sa_train_plain

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


@pytest.mark.parametrize("dtype,b,lq,lk,d,self_attn", [
    (dt, *case) for dt in DTYPES for case in ((33, 16, 6, 128, False),
                                              (9, 28, 28, 256, True))
] + [(torch.bfloat16, 5, 16, 16, 1024, True)])   # d=1024 runs the kernel in bf16 only
def test_mha_kernel(dev, dtype, b, lq, lk, d, self_attn):
    rng = np.random.default_rng(2)
    x = _randn(rng, (b, lq, d), dev).to(dtype)
    kv = x if self_attn else _randn(rng, (b, lk, d), dev).to(dtype)
    mats = [_randn(rng, (d, d), dev, 1 / math.sqrt(d)) for _ in range(4)]
    vecs = [_randn(rng, d, dev, 0.1) for _ in range(4)]
    mask = torch.from_numpy(rng.random((b, lk)) > 0.3).to(dev)
    mask[:, 0] = True
    mask[1] = False                                   # an all-masked sample
    args = (x, kv, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2], mats[3],
            vecs[3], _randn(rng, d, dev, 0.1, 1.0), _randn(rng, d, dev, 0.1), mask)
    before = cuda_mha.KERNEL.launches
    got = mha_addln(*args, num_heads=4)
    assert cuda_mha.KERNEL.launches == before + 1
    _close(got, mha_addln_plain(*args, num_heads=4), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,f", [(37, 128, 512), (1030, 256, 1024)])
def test_ffn_kernel(dev, dtype, rows, d, f):
    rng = np.random.default_rng(3)
    args = (_randn(rng, (rows, d), dev).to(dtype), _randn(rng, (d, f), dev, d ** -0.5),
            _randn(rng, f, dev, 0.1), _randn(rng, (f, d), dev, f ** -0.5),
            _randn(rng, d, dev, 0.1), _randn(rng, d, dev, 0.1, 1.0),
            _randn(rng, d, dev, 0.1))
    before = cuda_ffn.KERNEL.launches
    got = ffn_addln(*args)
    assert cuda_ffn.KERNEL.launches == before + 1
    _close(got, ffn_addln_plain(*args), dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    pts = torch.rand(4, 32, 3, device=dev)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.double(), 8)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.transpose(0, 1), 8)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sampling_cuda(pts.cpu(), 8)
    x = torch.rand(2, 16, 1024, device=dev)        # f32 at d=1024: too big a block
    w = torch.rand(1024, 1024, device=dev)
    v = torch.rand(1024, device=dev)
    with pytest.raises(ValueError):
        cuda_mha.mha_addln_cuda(x, torch.rand(2, 16, 1024, device=dev), w, v, w, v,
                                w, v, w, v, v, v, num_heads=4)


def _sa_train_inputs(rng, dev, n, p, s, k, h1, h2):
    u = _randn(rng, (n, p, h1), dev)
    sv = _randn(rng, (n, s, h1), dev, 0.5)
    w2 = _randn(rng, (h1, h2), dev, h1 ** -0.5)
    vecs = [_randn(rng, h, dev, 0.1, mean) for h, mean in
            ((h2, 0.0), (h1, 1.0), (h1, 0.0), (h2, 1.0), (h2, 0.0))]
    idx = torch.from_numpy(rng.integers(0, p, (n, s, k)).astype(np.int32)).to(dev)
    maskm = torch.from_numpy(rng.random((n, s, k)) < 0.7).to(dev)
    maskm[0, 0] = False                               # a row without valid slots
    maskf = maskm.clone()
    maskf[-1] = False                                 # an object out of the statistics
    return (u, sv, w2, *vecs, idx, maskm, maskf)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,s,k,h1,h2", [(20, 256, 128, 32, 32, 64),
                                           (9, 128, 64, 32, 128, 128),
                                           (7, 64, 32, 32, 256, 256),
                                           (5, 40, 12, 5, 64, 32)])
def test_sa_train_kernels(dev, dtype, n, p, s, k, h1, h2):
    rng = np.random.default_rng(4)
    args = _sa_train_inputs(rng, dev, n, p, s, k, h1, h2)
    dout = _randn(rng, (n, s, h2), dev)
    diff = [a.clone().requires_grad_() for a in args[:8]]
    before = (cuda_sa_train.KERNEL_FWD.launches, cuda_sa_train.KERNEL_BWD.launches)
    out, stats = sa_train(*diff, *args[8:], compute_dtype=dtype)
    (out * dout).sum().backward()
    assert cuda_sa_train.KERNEL_FWD.launches > before[0]
    assert cuda_sa_train.KERNEL_BWD.launches > before[1]
    want_out, want_stats = sa_train_plain(*args, compute_dtype=dtype)
    _close(out, want_out, dtype)
    for g, w in zip(stats, want_stats):
        _close(g, w, dtype)
    assert (out[0, 0] == 0).all()
    m1, v1, m2, v2, n1 = want_stats
    aux1 = torch.zeros(8, h1, device=dev)
    aux2 = torch.zeros(8, h2, device=dev)
    for aux, m, v, g, be in ((aux1, m1, v1, args[4], args[5]),
                             (aux2, m2, v2, args[6], args[7])):
        inv = torch.rsqrt(v + 1e-5)
        aux[0], aux[1], aux[2], aux[3] = g * inv, be - m * g * inv, m, inv
    aux2[6] = args[3]
    want = sa_train_backward_plain(args[0], args[1], args[2], args[8], args[9], args[10],
                                   aux1, aux2, n1, dout, dtype)
    floor = 1e-3 * max(w.norm().item() for w in want)
    for d, w in zip(diff, want):
        got, w = d.grad.float().cpu(), w.float().cpu()
        assert torch.isfinite(got).all()
        rel = ((got - w).norm() / max(w.norm().item(), floor)).item()
        assert rel <= REL_L2[dtype], rel


def test_sa_train_kernels_are_deterministic(dev):
    rng = np.random.default_rng(6)
    args = _sa_train_inputs(rng, dev, 30, 128, 64, 32, 128, 128)
    dout = _randn(rng, (30, 64, 128), dev)
    runs = []
    for _ in range(2):
        diff = [a.clone().requires_grad_() for a in args[:8]]
        out, stats = sa_train(*diff, *args[8:])
        (out * dout).sum().backward()
        runs.append([out, *stats] + [d.grad for d in diff])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
