"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (the CPU path of its wrapper) is held against the
JAX Pallas kernel run in interpret mode on the same numpy-seeded inputs, in
f32: FPS bit-equal, the others at atol 1e-5 (f32 sums taken in another
order). The CUDA kernels themselves run only on the card:
tests/test_torch_port_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.ops import masked as jmasked
from text2loc_tpu.ops.ballquery import ball_query_knn as jax_ball_query
from text2loc_tpu.ops.pallas_ffn import fused_ffn_addlayernorm
from text2loc_tpu.ops.pallas_fps import farthest_point_sampling_pallas
from text2loc_tpu.ops.pallas_mha import fused_mha_addlayernorm
from text2loc_tpu.ops.pallas_pointconv import fold_bn_affine as jax_fold
from text2loc_tpu.ops.pallas_pointconv import fused_sa_select
from text2loc_tpu_torch.ops import masked as tmasked
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.ffn import ffn_addln, ffn_addln_plain
from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain, fps_gather
from text2loc_tpu_torch.ops.mha import mha_addln, mha_addln_plain
from text2loc_tpu_torch.ops.pointconv import fold_bn_affine, sa_select, sa_select_plain

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- FPS


def test_fps_plain_bit_equal_to_pallas_kernel():
    rng = np.random.default_rng(0)
    pts = rng.random((16, 64, 3)).astype(np.float32)
    # Duplicate points create exact distance ties: first-max tie-breaking
    # must agree too.
    pts[:, 32:40] = pts[:, 0:8]
    idx_j, xyz_j = farthest_point_sampling_pallas(
        jnp.asarray(pts), 24, tile_n=8, interpret=True, with_coords=True)
    idx_t, xyz_t = farthest_point_sampling_plain(_t(pts), 24)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(xyz_t.numpy(), np.asarray(xyz_j))
    assert idx_t.dtype == torch.int32


def test_fps_ladder_prefix_and_cpu_dispatch():
    rng = np.random.default_rng(1)
    pts = _t(rng.normal(size=(8, 48, 3)).astype(np.float32))
    full_idx, full_xyz = farthest_point_sampling_plain(pts, 24)
    for s in (12, 6):
        idx, xyz = farthest_point_sampling_plain(pts, s)
        np.testing.assert_array_equal(idx.numpy(), full_idx[:, :s].numpy())
        np.testing.assert_array_equal(xyz.numpy(), full_xyz[:, :s].numpy())
    sub, idx = fps_gather(pts, 24)          # CPU tensor -> the plain version
    np.testing.assert_array_equal(idx.numpy(), full_idx.numpy())
    np.testing.assert_array_equal(sub.numpy(), full_xyz.numpy())


# -------------------------------------------------------------- ball query


@pytest.mark.parametrize("first", [False, True])
def test_ball_query_matches_jax(first):
    rng = np.random.default_rng(2)
    src = rng.random((4, 40, 3)).astype(np.float32)
    query = src[:, :10].copy()
    want_idx, want_mask = jax_ball_query(jnp.asarray(src), jnp.asarray(query),
                                         0.35, 8, first=first)
    idx, mask = ball_query_knn(_t(src), _t(query), 0.35, 8, first=first)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


# ------------------------------------------------------------- SA "first"


def _sa_inputs(seed, n=6, p=32, s=12, c=5, h1=16, h2=24):
    rng = np.random.default_rng(seed)
    x = rng.random((n, p, c)).astype(np.float32)
    pos = rng.random((n, p, 3)).astype(np.float32)
    pos[:, 20:26] = pos[:, 0:6]                     # duplicate points
    centers = pos[:, :s].copy()
    centers[0, 3] = (5.0, 5.0, 5.0)                 # empty-radius row
    feat = np.concatenate([x, pos], axis=-1)
    w1 = (rng.normal(size=(c + 3, h1)) / math.sqrt(c + 3)).astype(np.float32)
    w2 = (rng.normal(size=(h1, h2)) / math.sqrt(h1)).astype(np.float32)
    ab1 = np.stack([1 + 0.1 * rng.normal(size=h1), 0.1 * rng.normal(size=h1)])
    ab2 = np.stack([1 + 0.1 * rng.normal(size=h2), 0.1 * rng.normal(size=h2)])
    return (feat, pos, centers, w1, w1[c:].copy(), ab1.astype(np.float32), w2,
            ab2.astype(np.float32))


def test_sa_select_first_plain_matches_pallas_kernel():
    args = _sa_inputs(3)
    radius, k = 0.45, 8      # dense: most centers see more than K in radius
    want = fused_sa_select(*(jnp.asarray(a) for a in args), radius=radius, k=k,
                           interpret=True, selection="first")
    got = sa_select_plain(*(_t(a) for a in args), radius, k, selection="first")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.all(got.numpy()[0, 3] == 0.0)       # empty row pools to 0
    # The CPU dispatch takes the plain version.
    np.testing.assert_array_equal(
        sa_select(*(_t(a) for a in args), radius, k).numpy(), got.numpy())


def test_fold_bn_affine_matches_jax():
    rng = np.random.default_rng(4)
    b, sc, sh, mu = (rng.normal(size=7).astype(np.float32) for _ in range(4))
    var = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    want = jax_fold(*(jnp.asarray(a) for a in (b, sc, sh, mu, var)))
    got = fold_bn_affine(*(_t(a) for a in (b, sc, sh, mu, var)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# -------------------------------------------------------------------- MHA


def _mha_inputs(seed, b, lq, lk, d, heads, self_attn):
    rng = np.random.default_rng(seed)
    dh = d // heads
    x = rng.normal(size=(b, lq, d)).astype(np.float32)
    kv = x if self_attn else rng.normal(size=(b, lk, d)).astype(np.float32)
    mats = [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32)
            for _ in range(4)]
    vecs = [(0.1 * rng.normal(size=d)).astype(np.float32) for _ in range(4)]
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    mask = rng.random((b, lk)) > 0.3
    mask[:, 0] = True
    mask[1] = False                       # an all-masked sample
    jax_args = (x, kv, mats[0].reshape(d, heads, dh), vecs[0].reshape(heads, dh),
                mats[1].reshape(d, heads, dh), vecs[1].reshape(heads, dh),
                mats[2].reshape(d, heads, dh), vecs[2].reshape(heads, dh),
                mats[3].reshape(heads, dh, d), vecs[3], scale, bias)
    port = [_t(a) for a in (x, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2],
                            mats[3], vecs[3], scale, bias)]
    x_t = port[0]
    port_args = (x_t, x_t if self_attn else _t(kv), *port[1:])
    return jax_args, port_args, mask


@pytest.mark.parametrize("b,lq,lk,d,self_attn", [
    (5, 16, 6, 128, False),     # the CCT's cross block; B not a group multiple
    (3, 16, 16, 1024, True),    # the intra stack's lane-aligned branch
])
def test_mha_plain_matches_pallas_kernel(b, lq, lk, d, self_attn):
    jax_args, port_args, mask = _mha_inputs(5, b, lq, lk, d, 4, self_attn)
    want = fused_mha_addlayernorm(*(jnp.asarray(a) for a in jax_args),
                                  key_mask=jnp.asarray(mask), num_heads=4,
                                  interpret=True)
    got = mha_addln_plain(*port_args, torch.from_numpy(mask), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        mha_addln(*port_args, torch.from_numpy(mask), num_heads=4).numpy(),
        got.numpy())


# -------------------------------------------------------------------- FFN


@pytest.mark.parametrize("rows,d,f", [(37, 128, 512), (1030, 256, 1024)])
def test_ffn_plain_matches_pallas_kernel(rows, d, f):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    w1 = (rng.normal(size=(d, f)) / math.sqrt(d)).astype(np.float32)
    w2 = (rng.normal(size=(f, d)) / math.sqrt(f)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    b2, bias = ((0.1 * rng.normal(size=d)).astype(np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    args = (x, w1, b1, w2, b2, scale, bias)
    want = fused_ffn_addlayernorm(*(jnp.asarray(a) for a in args), interpret=True)
    got = ffn_addln_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ffn_addln(*(_t(a) for a in args)).numpy(),
                                  got.numpy())


# ------------------------------------------------------------ masked ops


def test_masked_ops_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    m = rng.random((4, 5)) > 0.5
    m[2] = False
    pairs = [
        (tmasked.masked_max(_t(x), _t(m), dim=1), jmasked.masked_max(x, m, axis=1)),
        (tmasked.masked_mean(_t(x), _t(m), dim=1), jmasked.masked_mean(x, m, axis=1)),
        (tmasked.masked_softmax(_t(x[..., 0]), _t(m)),
         jmasked.masked_softmax(x[..., 0], m)),
        (tmasked.l2_normalize(_t(x)), jmasked.l2_normalize(x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
