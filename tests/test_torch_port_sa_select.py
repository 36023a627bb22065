"""The "first" SA kernel's plan and the level it computes, off the card.

The plan (ops/cuda_pointconv.pick_plan, the part of tile_plan that needs no
card, sized here with the occupancy of shared memory alone; on the card the
occupancy query decides): every level of Config() and small_test_config(),
in bf16 and f32, gets a tile layout that fits a block's shared memory;
outputs wider than 256 columns take column slices; K above 32 and widths
that are not multiples of 8 raise with their reason. select_smem mirrors
the kernel's layout() (the card tests hold the two equal).

The level: the card tests' geometry (an empty center, duplicate points,
centers with exactly K and with more than K points in radius, a number of
centers that no tile size divides; points on a 1/16 grid exactly at r)
through the port's CPU dispatch (the plain version) against the JAX
package's Pallas kernel in interpret mode, in f32 at atol 1e-5 (f32 sums
taken in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.ops.pallas_pointconv import fused_sa_select
from text2loc_tpu_torch.config import Config, small_test_config
from text2loc_tpu_torch.ops import _cuda
from text2loc_tpu_torch.ops import cuda_pointconv as cp
from text2loc_tpu_torch.ops.pointconv import sa_select

DTYPES = [torch.bfloat16, torch.float32]
ATOL = 1e-5
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024   # an H100 SM's shared memory, kept per block


def smem_occupancy(rows, resident, smem, budget=0):
    """Blocks one SM holds by its shared memory and its 2048 threads alone
    (the registers unknown off the card)."""
    return min(8, SMEM_PER_SM // (smem + SMEM_RESERVED))


def _levels(cfg):
    """(P, S, C+3, H1, H2, K) of each SA level of a config."""
    pn = cfg.model.pointnet
    p, out = pn.num_points, []
    for s, (cin, h1, h2) in zip(pn.sa_num_points, pn.sa_mlps):
        out.append((p, s, cin, h1, h2, pn.sa_max_neighbors))
        p = s
    return out


LEVELS = {"default": _levels(Config()), "small": _levels(small_test_config())}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config,level", [(c, i) for c in LEVELS for i in range(3)])
def test_first_plan_fits_every_config_level(config, level, dtype):
    p, s, c, h1, h2, k = LEVELS[config][level]
    plan = cp.pick_plan(p, s, c, h1, h2, k, dtype, smem_occupancy)
    assert plan.smem <= _cuda.SMEM_LIMIT
    assert plan.smem == cp.select_smem(p, s, c, h1, h2, k, plan.rows, plan.resident, dtype)
    assert plan.rows % 16 == 0 and k <= plan.rows <= cp.max_rows(h1, h2)
    assert plan.blocks_per_sm >= 1 and plan.slices == 1
    assert plan.budget == 0
    assert (plan.rows, plan.resident, plan.smem, 0) in cp.tile_layouts(p, s, c, h1, h2, k, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h2,slices", [(512, 2), (1024, 4)])
def test_first_plan_takes_wide_outputs_in_column_slices(h2, slices, dtype):
    plan = cp.pick_plan(64, 32, 131, 256, h2, 32, dtype, smem_occupancy)
    assert plan.slices == slices and plan.smem <= _cuda.SMEM_LIMIT
    # A streamed plan's tile holds one slice of y beside h1, whatever H2.
    streamed = [cp.select_smem(64, 32, 131, 256, w, 32, 64, 0, dtype) for w in (512, 1024)]
    assert streamed[0] == streamed[1]


@pytest.mark.parametrize("kw,match", [
    (dict(k=33), "K=33"), (dict(k=0), "K=0"), (dict(h2=20), "H2=20"),
    (dict(h1=12), "H1=12"), (dict(h2=4), "H2=4"), (dict(h1=1032), "H1=1032"),
    (dict(p=65536), "P=65536"),
])
def test_first_plan_rejects_what_the_kernel_does_not_take(kw, match):
    args = dict(p=64, s=32, c=131, h1=256, h2=256, k=32)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        cp.pick_plan(**args, dtype=torch.bfloat16, occupancy=smem_occupancy)


def test_first_plan_takes_the_most_rows_in_flight():
    level = (128, 64, 67, 128, 128, 32, torch.bfloat16)
    # Two streamed blocks of 128 rows beat one resident block.
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 1 if resident else 2)
    assert (plan.rows, plan.resident, plan.blocks_per_sm) == (128, 0, 2)
    # Four blocks of 64 rows beat one of 128; a tie goes to the resident W2.
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 4 if rows <= 64 else 1)
    assert (plan.rows, plan.resident, plan.blocks_per_sm) == (64, 1, 4)
    # Of equal rows in flight the taller tile: a tile costs a fixed chain.
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 4 if rows <= 64 else 2)
    assert (plan.rows, plan.resident, plan.blocks_per_sm) == (128, 1, 2)
    # A layout the card cannot hold once is never taken.
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 0 if rows == 128 else 1)
    assert plan.rows == 64
    with pytest.raises(ValueError, match="no tile layout"):
        cp.pick_plan(*level, lambda rows, resident, smem, budget: 0)
    # The widest class holds at most 64 rows a tile.
    assert cp.pick_plan(64, 32, 131, 256, 256, 32, torch.bfloat16, lambda *a: 1).rows == 64


def _geometry(rng, kind, n, p, s, k, radius):
    """pos [n, p, 3] and centers [n, s, 3] (f32) of the card tests' cases:
    "clusters": random points, duplicates, a line of K + 3 points whose
    first K lie within radius of center 0 and all of them within radius of
    center 1, an empty center 5 in cloud 0; "voxel": points and centers on a
    1/16 grid, so that many points lie exactly at r = 4/16."""
    if kind == "voxel":
        pos = (rng.integers(-8, 9, (n, p, 3)) / 16.0).astype(np.float32)
        return pos, pos[:, :s].copy()
    pos = (rng.random((n, p, 3)) - 0.5).astype(np.float32)
    pos[:, 10:15] = pos[:, 0:5]                      # duplicate points
    step = radius / (k - 0.5)
    line = np.zeros((k + 3, 3), np.float32) + 2.0
    line[:, 0] += step * np.arange(k + 3)
    pos[:, p - k - 3:] = line
    centers = pos[:, :s].copy()
    centers[:, 0] = (2.0, 2.0, 2.0)                  # exactly K in radius
    centers[:, 1] = (2.0 + step * ((k + 2) // 2), 2.0, 2.0)   # K + 3 in radius
    centers[0, 5] = (9.0, 9.0, 9.0)                  # none in radius
    return pos, centers


@pytest.mark.parametrize("kind,radius", [("clusters", 0.3), ("voxel", 0.25)])
def test_first_level_cases_match_pallas_kernel(kind, radius):
    rng = np.random.default_rng(11)
    n, p, s, c, h1, h2, k = 3, 48, 13, 5, 16, 24, 8
    pos, centers = _geometry(rng, kind, n, p, s, k, radius)
    x = rng.random((n, p, c)).astype(np.float32)
    feat = np.concatenate([x, pos], axis=-1)
    w1 = (rng.normal(size=(c + 3, h1)) / math.sqrt(c + 3)).astype(np.float32)
    w2 = (rng.normal(size=(h1, h2)) / math.sqrt(h1)).astype(np.float32)
    ab1 = np.stack([1 + 0.1 * rng.normal(size=h1), 0.1 * rng.normal(size=h1)])
    ab2 = np.stack([1 + 0.1 * rng.normal(size=h2), 0.1 * rng.normal(size=h2)])
    args = (feat, pos, centers, w1, w1[c:].copy(), ab1.astype(np.float32), w2,
            ab2.astype(np.float32))
    want = np.asarray(fused_sa_select(*(jnp.asarray(a) for a in args), radius=radius, k=k,
                                      interpret=True, selection="first"))
    got = sa_select(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), radius, k)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if kind == "clusters":
        d2 = ((pos[:, :, None, :] - centers[:, None, :2, :]) ** 2).sum(-1)
        assert ((d2 <= radius * radius).sum(1) == [k, k + 3]).all()
        assert np.all(got.numpy()[0, 5] == 0.0)
