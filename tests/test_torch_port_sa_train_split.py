"""The f32 training SA backward's products as the card computes them (3xTF32,
csrc/sa_train_bwd.cuh), emulated on the CPU at the third level's width.

On the card the f32 backward runs its three products per tile (z = h1 W2,
dh1 = dz W2^T, dW2 = h1^T dz) on TF32 tensor cores with each operand x
split into hi = x rounded to TF32 (10 mantissa bits, round half away from
zero: cvt.rna.tf32.f32) and lo = (x - hi) rounded the same way, summing
lo.hi + hi.lo + hi.hi in f32. Here the same split runs through torch
(each partial product of two TF32 values is exact in f32), inside a copy
of the hand-derived backward that takes its matrix product as an
argument. The copy is first held equal to ops/sa_train.sa_train_backward_
plain; then the split backward in f32 is held against the copy in f64,
where every gradient must lie far inside the card's f32 limit (rel-L2 1e-3
of the plain norm, floored at 1e-3 x the largest gradient norm): within
1e-4, and within twice the plain f32 backward's own error. Products on
TF32 alone (operands rounded, no lo terms) miss the limit: the near-ties of
the neighbour max and the ReLUs flip. The forward's z (csrc/sa_train_fwd.cuh
forms it with the same product) is held within 1e-6 of f64 in the card's
order of sums: per k8 step a zeroed partial, then the accumulator.
"""

import numpy as np
import pytest
import torch

from text2loc_tpu_torch.ops.sa_train import sa_train_backward_plain, sa_train_plain

NEG = -1.0e30
REL_L2_F32 = 1e-3      # chip_smoke.py / tests/test_torch_port_cuda.py
SPLIT_LIMIT = 1e-4     # "far inside": a tenth of it


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits), ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32 (f32 operands and sums)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def split_mm_k8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the card's order (csrc/sa_train_tiles.cuh mma_step): per k8
    step the three TF32 products summed into a zeroed f32 partial, which is
    then added to the f32 accumulator, steps in k order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        a8, b8 = a[:, k0:k0 + 8].contiguous(), b[k0:k0 + 8].contiguous()
        a_hi, b_hi = tf32_rna(a8), tf32_rna(b8)
        a_lo, b_lo = tf32_rna(a8 - a_hi), tf32_rna(b8 - b_hi)
        acc = acc + (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi)
    return acc


def backward(u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout, mm):
    """sa_train_backward_plain at compute dtype f32 (the recompute
    function), in the dtype of its inputs, with the products through
    mm(a, b)."""
    n, p, h1w = u.shape
    s, k = idx.shape[1:]
    dims = (0, 1, 2)
    mf = maskf.to(u.dtype)[..., None]
    mmask = maskm[..., None]
    flat = idx.reshape(n, s * k, 1).long().expand(n, s * k, h1w)
    e = torch.gather(u, 1, flat).reshape(n, s, k, h1w) - sv[:, :, None, :]
    y1 = e * aux1[0] + aux1[1]
    h1 = torch.relu(y1)
    z = mm(h1.reshape(-1, h1w), w2).reshape(n, s, k, -1) + aux2[6]
    y2 = z * aux2[0] + aux2[1]
    filled = torch.where(mmask, torch.relu(y2), torch.full((), NEG, dtype=u.dtype))
    mx = filled.amax(dim=2, keepdim=True)
    eq = ((filled >= mx) & mmask).to(u.dtype)
    cnt = torch.clamp(eq.sum(dim=2, keepdim=True), min=1.0)
    dy2 = dout[:, :, None, :] * eq / cnt * (y2 > 0).to(u.dtype)
    yhat2 = (z - aux2[2]) * aux2[3]
    dbe2, dg2 = dy2.sum(dims), (dy2 * yhat2).sum(dims)
    dz = aux2[0] * (dy2 - mf * (dbe2 / n1 + yhat2 * (dg2 / n1)))
    dzf = dz.reshape(-1, dz.shape[-1])
    dh1 = mm(dzf, w2.t().contiguous()).reshape(n, s, k, h1w)
    dy1 = dh1 * (y1 > 0).to(u.dtype)
    yhat1 = (e - aux1[2]) * aux1[3]
    dbe1, dg1 = dy1.sum(dims), (dy1 * yhat1).sum(dims)
    de = aux1[0] * (dy1 - mf * (dbe1 / n1 + yhat1 * (dg1 / n1)))
    dw2 = mm(h1.reshape(-1, h1w).t().contiguous(), dzf)
    db2 = dz.sum(dims)
    du = torch.zeros((n, p, h1w), dtype=u.dtype)
    du.scatter_add_(1, flat, de.reshape(n, s * k, h1w))
    dsv = -de.sum(dim=2)
    return du, dsv, dw2, db2, dg1, dbe1, dg2, dbe2


def _level(seed, n=4, p=64, s=32, k=32, h1=256, h2=256):
    """A third-level case (H 256 -> 256, K=32): ragged validity, one row
    without valid slots, the last cloud out of the statistics; the forward's
    aux rows from the plain forward."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + mean).astype(np.float32))

    u, sv, w2 = t((n, p, h1)), t((n, s, h1), 0.5), t((h1, h2), h1 ** -0.5)
    b2, be1, be2 = t(h2, 0.1), t(h1, 0.1), t(h2, 0.1)
    g1, g2 = t(h1, 0.1, 1.0), t(h2, 0.1, 1.0)
    idx = torch.from_numpy(rng.integers(0, p, (n, s, k)).astype(np.int32))
    maskm = torch.from_numpy(rng.random((n, s, k)) < 0.4)
    maskm[0, 0] = False
    maskf = maskm.clone()
    maskf[-1] = False
    dout = t((n, s, h2))
    _, (m1, v1, m2, v2, n1) = sa_train_plain(u, sv, w2, b2, g1, be1, g2, be2, idx, maskm,
                                             maskf)
    aux1, aux2 = torch.zeros(8, h1), torch.zeros(8, h2)
    for aux, m, v, g, be in ((aux1, m1, v1, g1, be1), (aux2, m2, v2, g2, be2)):
        inv = torch.rsqrt(v + 1e-5)
        aux[0], aux[1], aux[2], aux[3] = g * inv, be - m * g * inv, m, inv
    aux2[6] = b2
    return u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout


def _rel_l2(got, want):
    floor = 1e-3 * max(w.norm().item() for w in want)
    return [((g.double() - w).norm() / max(w.norm().item(), floor)).item()
            for g, w in zip(got, want)]


def test_tf32_rna_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    y = torch.randn(1000)
    assert (tf32_rna(y).view(torch.int32) & 0x1FFF == 0).all()
    assert ((tf32_rna(y) - y).abs() <= y.abs() * 2.0 ** -11).all()


def test_split_product_is_f32_accurate():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 256, generator=g), torch.randn(256, 256, generator=g)
    exact = a.double() @ b.double()
    tf32 = (tf32_rna(a) @ tf32_rna(b)).double()
    err_split = ((split_mm(a, b).double() - exact).norm() / exact.norm()).item()
    err_f32 = (((a @ b).double() - exact).norm() / exact.norm()).item()
    err_tf32 = ((tf32 - exact).norm() / exact.norm()).item()
    assert err_split < 4 * err_f32 + 1e-7
    assert err_tf32 > 100 * err_split


@pytest.mark.parametrize("seed", [0, 1])
def test_split_backward_lies_far_inside_the_f32_limit(seed):
    args = _level(seed)
    plain = sa_train_backward_plain(*args)
    mirror = backward(*args, mm=torch.matmul)
    for g, w in zip(mirror, plain):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    ref = backward(*(a.double() if a.is_floating_point() else a for a in args),
                   mm=torch.matmul)
    split = backward(*args, mm=split_mm)
    tf32 = backward(*args, mm=lambda a, b: tf32_rna(a) @ tf32_rna(b))
    rel_split, rel_plain = _rel_l2(split, ref), _rel_l2(plain, ref)
    assert max(rel_split) <= SPLIT_LIMIT, (rel_split, rel_plain)
    for r_split, r_plain in zip(rel_split, rel_plain):
        assert r_split <= 2 * r_plain + 1e-7, (rel_split, rel_plain)
    assert max(_rel_l2(tf32, ref)) > REL_L2_F32


@pytest.mark.parametrize("seed", [0, 1])
def test_split_forward_z_lies_within_1e_6_of_f64(seed):
    """The forward's z = h1 W2 + b2 (csrc/sa_train_fwd.cuh, the backward's
    product) in the card's 3xTF32 order, at the third level's width, within
    1e-6 x max|z| of z in f64; on TF32 alone it is not."""
    u, sv, w2, idx, maskm, _, aux1, aux2, _, _ = _level(seed)
    n, _, h1w = u.shape
    s, k = idx.shape[1:]
    flat = idx.reshape(n, s * k, 1).long().expand(n, s * k, h1w)
    e = torch.gather(u, 1, flat) - sv.repeat_interleave(k, dim=1)
    h1 = torch.relu(e * aux1[0] + aux1[1]).reshape(-1, h1w)[maskm.reshape(-1)]
    z64 = h1.double() @ w2.double() + aux2[6].double()
    peak = z64.abs().max().item()
    err = ((split_mm_k8(h1, w2) + aux2[6]).double() - z64).abs().max().item()
    assert err <= 1e-6 * peak, err / peak
    tf32 = ((tf32_rna(h1) @ tf32_rna(w2) + aux2[6]).double() - z64).abs().max().item()
    assert tf32 > 1e-4 * peak
