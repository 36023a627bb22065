"""The tiled chains' f32 products as the card computes them (3xTF32 on
wgmma, csrc/gemm_wgmma.cuh gemm_tf32x3_kernel), emulated on the CPU, and
the weights' split (csrc/tf32_split.cu) by its plain version.

On the card every f32 product of the attention chain (the projections, the
out-projection) and of the feed-forward chain (the hidden product, the
residual product at K = F) runs on TF32 tensor cores with each operand x
split into hi = x rounded to TF32 (10 mantissa bits, round half away from
zero: cvt.rna.tf32.f32) and lo = (x - hi) rounded the same way: the
weights by the split kernel (W^T's hi and lo, [N, K]), the activations in
registers. Per k slice of 32 the products lo.hi, hi.lo, hi.hi (in that
order, each over the slice's four k8 steps) sum into a zeroed partial,
which is then added to the f32 accumulator, slices in k order. Here the
same split and order run through torch (each product of two TF32 values is
exact in f32), at a few hundred rows and the chains' widths (D = 1024, F =
4096; D = 128, 512), and the emulated stages are held:

- against the port's plain stages (ops/ffn.py, ops/mha.py) at the card's
  f32 limit, 1e-4 x max|plain| (chip_smoke.py's TOLERANCE);
- their products against f64, within 1e-5 x max|f64|;
- against the same products on TF32 alone (operands rounded, no lo terms),
  which lie at least 10x further from f64.
"""

import math

import numpy as np
import pytest
import torch

from text2loc_tpu_torch.ops import cuda_split
from text2loc_tpu_torch.ops.ffn import ffn_hidden_plain, ffn_out_addln_plain
from text2loc_tpu_torch.ops.mha import (layer_norm_f32, mha_out_addln_plain,
                                        mha_project_plain)
from text2loc_tpu_torch.ops.cuda_split import split_t_plain, tf32_rna

TOLERANCE_F32 = 1e-4   # chip_smoke.py: x max|plain|
F64_LIMIT = 1e-5       # x max|f64|
SLICE = 32             # k of a ring slice (gemm_wgmma.cuh tf32::kBK)


def card_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in f32 as gemm_tf32x3_kernel forms it: a split
    in hi / lo, b by its transposed split (split_t_plain, as the kernel reads
    it), per slice of 32 k the twelve k8 products into a zeroed partial
    (lo.hi over the four steps, then hi.lo, then hi.hi), the partial added
    to the accumulator."""
    m, k = a.shape
    n = b.shape[1]
    bt_hi, bt_lo = (t.view(n, k) for t in split_t_plain([b]))
    a_hi = tf32_rna(a)
    a_lo = tf32_rna(a - a_hi)
    acc = None
    for k0 in range(0, k, SLICE):
        part = torch.zeros(m, n)
        steps = range(k0, min(k0 + SLICE, k), 8)
        for left, right in ((a_lo, bt_hi), (a_hi, bt_lo), (a_hi, bt_hi)):
            for s in steps:
                part = part + left[:, s:s + 8] @ right[:, s:s + 8].t()
        acc = part if acc is None else acc + part
    return acc


def tf32_mm(a, b):
    """a @ b on TF32 alone: both operands rounded, f32 sums."""
    return tf32_rna(a) @ tf32_rna(b.contiguous())


def _t(rng, shape, scale=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + mean).astype(np.float32))


def _ffn_inputs(seed, rows, d, f):
    """Activations and f32 weights as chip_smoke.py makes them: x ~ N(0, 1),
    W1 ~ N(0, 1/D), W2 ~ N(0, 1/F), biases 0.1, LayerNorm near 1 and 0."""
    rng = np.random.default_rng(seed)
    return (_t(rng, (rows, d)), _t(rng, (d, f), d ** -0.5), _t(rng, f, 0.1),
            _t(rng, (f, d), f ** -0.5), _t(rng, d, 0.1), _t(rng, d, 0.1, 1.0), _t(rng, d, 0.1))


def _errors(got, tf32, ref64):
    """(emulated, TF32-alone) largest errors against the f64 reference, and
    max|f64|."""
    ref = ref64.double()
    return ((got.double() - ref).abs().max().item(), (tf32.double() - ref).abs().max().item(),
            ref.abs().max().item())


def _close(got, want, limit):
    err = (got - want).abs().max().item()
    assert err <= limit * want.abs().max().item(), err / want.abs().max().item()


def _check_product(got, tf32, ref64):
    err, err_tf32, peak = _errors(got, tf32, ref64)
    assert err <= F64_LIMIT * peak, err / peak
    assert err_tf32 >= 10 * err, (err_tf32, err)


@pytest.mark.parametrize("rows,d,f", [(200, 1024, 4096), (300, 128, 512), (300, 512, 2048)])
def test_ffn_chain_products_on_3xtf32(rows, d, f):
    """The feed-forward chain's two products (the hidden with its bias and
    ReLU, the residual sum s2 at K = F) and its stages as the card forms
    them: the stages within the card's f32 limit of the plain stages, the
    products within 1e-5 of f64, TF32 alone 10x further."""
    x, w1, b1, w2, b2, g, be = _ffn_inputs(rows + d, rows, d, f)
    pre = card_mm(x, w1) + b1
    h = torch.relu(pre)
    _close(h, ffn_hidden_plain(x, w1, b1), TOLERANCE_F32)
    _check_product(pre, tf32_mm(x, w1) + b1, x.double() @ w1.double() + b1.double())
    hp = ffn_hidden_plain(x, w1, b1)
    s2 = x + card_mm(hp, w2) + b2
    _close(layer_norm_f32(s2, g, be, 1e-5), ffn_out_addln_plain(hp, x, w2, b2, g, be),
           TOLERANCE_F32)
    _check_product(s2, x + tf32_mm(hp, w2) + b2,
                   x.double() + hp.double() @ w2.double() + b2.double())


@pytest.mark.parametrize("b,lq,lk,d,self_attn", [(13, 16, 16, 1024, True),
                                                 (12, 16, 6, 512, False),
                                                 (20, 16, 16, 128, True)])
def test_mha_chain_products_on_3xtf32(b, lq, lk, d, self_attn):
    """The attention chain's projections (self: one product over the packed
    [Wq|Wk|Wv], whose split is the three weights' splits one after another;
    cross: x Wq and kv [Wk|Wv]) and its out-projection with the residual, as
    the card forms them: within the card's f32 limit of the plain stages,
    the products within 1e-5 of f64, TF32 alone 10x further."""
    rng = np.random.default_rng(b * d + lk)
    x = _t(rng, (b, lq, d))
    kv = x if self_attn else _t(rng, (b, lk, d))
    wq, wk, wv, wo = (_t(rng, (d, d), d ** -0.5) for _ in range(4))
    bq, bk, bv, bo = (_t(rng, d, 0.1) for _ in range(4))
    g, be = _t(rng, d, 0.1, 1.0), _t(rng, d, 0.1)
    scale = 1.0 / math.sqrt(d // 4)
    x2, kv2 = x.reshape(-1, d), kv.reshape(-1, d)
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    # The packed split the block reads is the concatenation of the splits.
    hi, lo = split_t_plain([wq, wk, wv])
    packed_hi, packed_lo = split_t_plain([wqkv])
    assert torch.equal(hi, packed_hi) and torch.equal(lo, packed_lo)
    if self_attn:
        qkv = card_mm(x2, wqkv) + bqkv
        q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        products = [(qkv, tf32_mm(x2, wqkv) + bqkv, x2.double() @ wqkv.double() + bqkv.double())]
    else:
        q = card_mm(x2, wq) + bq
        kvp = card_mm(kv2, wqkv[:, d:]) + bqkv[d:]
        k, v = kvp[:, :d], kvp[:, d:]
        products = [(q, tf32_mm(x2, wq) + bq, x2.double() @ wq.double() + bq.double()),
                    (kvp, tf32_mm(kv2, wqkv[:, d:]) + bqkv[d:],
                     kv2.double() @ wqkv[:, d:].double() + bqkv[d:].double())]
    want = mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, num_heads=4)
    for got, w in zip((q * scale, k, v), want):
        _close(got.reshape(w.shape), w, TOLERANCE_F32)
    for product in products:
        _check_product(*product)
    o = want[0]   # any f32 [B, Lq, D] rows: the out-projection's A
    o2 = o.reshape(-1, d)
    s2 = x2 + card_mm(o2, wo) + bo
    _close(layer_norm_f32(s2, g, be, 1e-5).reshape(x.shape),
           mha_out_addln_plain(x, o, wo, bo, g, be), TOLERANCE_F32)
    _check_product(s2, x2 + tf32_mm(o2, wo) + bo,
                   x2.double() + o2.double() @ wo.double() + bo.double())


def test_slice_partials_sum_within_f32_of_the_plain_product():
    """K not a multiple of the slice's 32 (the emulation's last slice is
    short) and one row of zeros: the emulated product stays within the
    card's limit of the f32 product, and a zero row gives exact zeros."""
    rng = np.random.default_rng(5)
    a, b = _t(rng, (33, 200)), _t(rng, (200, 96), 200 ** -0.5)
    a[7] = 0.0
    got = card_mm(a, b)
    _close(got, a @ b, TOLERANCE_F32)
    assert torch.equal(got[7], torch.zeros(96))


def test_tf32_rna_rounds_to_ten_mantissa_bits_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -10, 3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 3.0, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x).view(torch.int32), want.view(torch.int32))
    y = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    assert (tf32_rna(y).view(torch.int32) & 0x1FFF == 0).all()
    assert ((tf32_rna(y) - y).abs() <= y.abs() * 2.0 ** -11).all()


def test_split_t_plain_layout_and_reconstruction():
    """The plain split: for each weight W [K, N] its W^T [N, K], row-major,
    one weight after another in two flat buffers; hi is W^T rounded to
    TF32, lo the rounded remainder (both with 13 zero low bits), and hi + lo
    is W to within 2^-21 of |W| (22 significant bits kept); a weight is
    never changed."""
    g = torch.Generator().manual_seed(2)
    mats = [torch.randn(64, 96, generator=g), torch.randn(96, 64, generator=g) * 1e-3,
            torch.randn(32, 32, generator=g) * 1e4]
    before = [m.clone() for m in mats]
    hi, lo = split_t_plain(mats)
    assert hi.shape == lo.shape == (sum(m.numel() for m in mats),)
    assert hi.dtype == lo.dtype == torch.float32
    at = 0
    for m, m0 in zip(mats, before):
        assert torch.equal(m, m0)
        k, n = m.shape
        h, l = hi[at:at + k * n].view(n, k), lo[at:at + k * n].view(n, k)
        at += k * n
        wt = m.t()
        assert torch.equal(h, tf32_rna(wt.contiguous()))
        assert torch.equal(l, tf32_rna((wt - h).contiguous()))
        for t in (h, l):
            assert (t.contiguous().view(torch.int32) & 0x1FFF == 0).all()
        assert ((h + l - wt).abs() <= wt.abs() * 2.0 ** -21).all()
        assert ((h - wt).abs() <= wt.abs() * 2.0 ** -11).all()
    assert at == hi.numel()


def test_stage_args_launch_nothing_outside_f32():
    """The chains' stage entries take the split in f32 only: in bf16 their
    split arguments are two NULLs and nothing is split."""
    g = torch.Generator().manual_seed(3)
    mats = [torch.randn(16, 48, generator=g), torch.randn(48, 16, generator=g)]
    before = cuda_split.KERNEL.launches
    assert cuda_split.stage_args(mats, torch.bfloat16) == ((None, None), ())
    assert cuda_split.KERNEL.launches == before


def test_split_t_cuda_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper raises before any launch: on CPU tensors (a
    matrix or not) and on more than four weights."""
    w = torch.zeros(8, 8)
    before = cuda_split.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_split.split_t_cuda([w])
    with pytest.raises(ValueError, match="1 to 4"):
        cuda_split.split_t_cuda([w] * 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_split.split_t_cuda([torch.zeros(8)])
    assert cuda_split.KERNEL.launches == before
