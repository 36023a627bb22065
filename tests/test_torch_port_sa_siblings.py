"""The "gather", "all", "bisect" and "exact" SA levels on the tile kernel,
off the card.

The levels: each plain version (the port's CPU path) against its Pallas
kernel in interpret mode, in f32 at atol 1e-5 (f32 sums taken in another
order): fused_set_abstraction without K selection at P = 160 (above the
tallest tile of 128 rows) where one center holds every point of its cloud,
and fused_sa_gather with masks that have holes in mid-row, a duplicated
neighbour and an all-invalid row.

The plans (ops/cuda_pointconv.pick_plan with selection "gather", "all",
"bisect" or "exact", sized here with the occupancy of shared memory alone;
on the card the occupancy query decides): every level of Config() and
small_test_config(), in bf16 and f32, gets a tile layout that fits a
block's shared memory; what the kernel does not take raises with its
reason; "all" cuts a cloud's centers into groups whose rows fit the row
map's budget (cuda_pointconv.all_groups, as the kernel cuts them);
"exact" sizes as "first" but for its u in f32. (The bisect and exact
levels against their Pallas kernels: tests/test_torch_port_sa_modes.py.)
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.ops.pallas_pointconv import fused_sa_gather, fused_set_abstraction
from text2loc_tpu_torch.config import Config, small_test_config
from text2loc_tpu_torch.ops import _cuda
from text2loc_tpu_torch.ops import cuda_pointconv as cp
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.pointconv import (sa_gather, sa_gather_plain, set_abstraction,
                                              set_abstraction_plain)

DTYPES = [torch.bfloat16, torch.float32]
ATOL = 1e-5
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024   # an H100 SM's shared memory, kept per block


def smem_occupancy(rows, resident, smem, budget):
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _weights(rng, c, h1, h2):
    w1 = (rng.normal(size=(c + 3, h1)) / math.sqrt(c + 3)).astype(np.float32)
    w2 = (rng.normal(size=(h1, h2)) / math.sqrt(h1)).astype(np.float32)
    ab1 = np.stack([1 + 0.1 * rng.normal(size=h1), 0.1 * rng.normal(size=h1)])
    ab2 = np.stack([1 + 0.1 * rng.normal(size=h2), 0.1 * rng.normal(size=h2)])
    return w1, w2, ab1.astype(np.float32), ab2.astype(np.float32)


def test_all_plain_matches_pallas_kernel_where_a_center_holds_every_point():
    rng = np.random.default_rng(21)
    n, p, s, c, h1, h2, radius = 2, 160, 12, 5, 16, 24, 0.45
    pos = rng.random((n, p, 3)).astype(np.float32)
    pos[0] = 0.5 + 0.3 * (pos[0] - 0.5)          # cloud 0 inside a 0.3 cube
    centers = pos[:, :s].copy()
    centers[0, 0] = (0.5, 0.5, 0.5)               # holds all of cloud 0
    centers[1, 3] = (5.0, 5.0, 5.0)               # holds none
    x = rng.random((n, p, c)).astype(np.float32)
    w1, w2, ab1, ab2 = _weights(rng, c, h1, h2)
    args = (x, pos, centers, w1[:c].copy(), w1[c:].copy(), ab1, w2, ab2)
    d2 = ((pos[:, None, :, :] - centers[:, :, None, :]) ** 2).sum(-1)
    assert (d2[0, 0] <= radius * radius).all() and not (d2[1, 3] <= radius * radius).any()
    want = np.asarray(fused_set_abstraction(*(jnp.asarray(a) for a in args), radius=radius,
                                            k=8, interpret=True, select_k=False))
    got = set_abstraction_plain(*(_t(a) for a in args), radius, 8, select_k=False)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[1, 3] == 0.0)
    np.testing.assert_array_equal(
        set_abstraction(*(_t(a) for a in args), radius, 8, select_k=False).numpy(),
        got.numpy())


def test_gather_plain_matches_pallas_kernel_with_holes_and_duplicates():
    rng = np.random.default_rng(22)
    n, p, s, c, h1, h2, k = 3, 48, 10, 5, 16, 24, 8
    pos = rng.random((n, p, 3)).astype(np.float32)
    centers = pos[:, :s].copy()
    x = rng.random((n, p, c)).astype(np.float32)
    feat = np.concatenate([x, pos], -1)
    w1, w2, ab1, ab2 = _weights(rng, c, h1, h2)
    idx, mask = ball_query_knn(_t(pos), _t(centers), 0.5, k)
    idx, mask = idx.numpy().astype(np.int32), mask.numpy().copy()
    mask[:, :, 2] = False                         # holes in mid-row
    mask[:, ::3, 4:6] = False
    idx[:, :, 1] = idx[:, :, 0]                   # a duplicated neighbour, valid
    mask[:, :, 1] = mask[:, :, 0]
    mask[2, 7] = False                            # an all-invalid row
    assert mask[:, :, 3].any() and mask[:, :, 1].any()
    tail = (w1, w1[c:].copy(), ab1, w2, ab2)
    want = np.asarray(fused_sa_gather(jnp.asarray(feat), jnp.asarray(centers),
                                      jnp.asarray(idx), jnp.asarray(mask),
                                      *(jnp.asarray(a) for a in tail), interpret=True))
    args = (_t(feat), _t(centers), _t(idx).long(), _t(mask), *(_t(a) for a in tail))
    got = sa_gather_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[2, 7] == 0.0)
    np.testing.assert_array_equal(sa_gather(*args).numpy(), got.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selection", ["gather", "all", "bisect", "exact"])
@pytest.mark.parametrize("config,level", [(c, i) for c in LEVELS for i in range(3)])
def test_tile_plans_fit_every_config_level(config, level, selection, dtype):
    p, s, c, h1, h2, k = LEVELS[config][level]
    # "all" and "exact" read x, not concat(x, pos).
    c = c - 3 if selection in cp.U_F32 else c
    plan = cp.pick_plan(p, s, c, h1, h2, k, dtype, smem_occupancy, selection)
    assert plan.smem <= _cuda.SMEM_LIMIT and plan.blocks_per_sm >= 1 and plan.slices == 1
    assert plan.smem == cp.select_smem(p, s, c, h1, h2, k, plan.rows, plan.resident, dtype,
                                       selection, plan.budget)
    assert plan.rows % 16 == 0 and plan.rows <= cp.max_rows(h1, h2)
    if selection == "all":
        assert plan.budget in cp.ALL_BUDGETS and plan.budget >= p
    else:
        assert plan.budget == 0 and plan.rows >= k
    assert plan[:3] + (plan.budget,) in cp.tile_layouts(p, s, c, h1, h2, k, dtype, selection)


@pytest.mark.parametrize("selection,kw,match", [
    ("gather", dict(k=33), "K=33"), ("gather", dict(k=0), "K=0"),
    ("gather", dict(h2=20), "H2=20"), ("gather", dict(h1=1032), "H1=1032"),
    ("gather", dict(p=65536), "P=65536"), ("all", dict(p=4097), "P=4097"),
    ("all", dict(s=32768), "S=32768"), ("all", dict(h1=12), "H1=12"),
    ("bisect", dict(p=257), "at most 256"), ("exact", dict(p=257), "at most 256"),
    ("bisect", dict(k=33), "K=33"), ("exact", dict(k=33), "K=33"),
    ("bisect", dict(h2=20), "H2=20"), ("exact", dict(h1=1032), "H1=1032"),
    ("nearest", {}, "selection"),
])
def test_tile_plans_reject_what_the_kernel_does_not_take(selection, kw, match):
    args = dict(p=64, s=32, c=128, h1=256, h2=256, k=32)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        cp.pick_plan(**args, dtype=torch.bfloat16, occupancy=smem_occupancy,
                     selection=selection)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,s,c,h1,h2", [(256, 128, 6, 32, 64), (128, 64, 67, 128, 128),
                                         (64, 32, 131, 256, 256), (64, 300, 131, 256, 512)])
def test_exact_sizes_as_first_with_u_in_f32(dtype, p, s, c, h1, h2):
    """Selection "bisect" takes "first"'s layout; "exact" "first"'s lists and
    row map with "all"'s f32 u [P][H1 + 4] in place of u [P][H1 + pad] in
    the dtype."""
    es, pad = (2, 8) if dtype == torch.bfloat16 else (4, 4)
    u_diff = cp._align16(4 * p * (h1 + 4)) - cp._align16(es * p * (h1 + pad))
    for rows, resident in cp.TILE_LAYOUTS:
        first = cp.select_smem(p, s, c, h1, h2, 32, rows, resident, dtype, "first")
        assert cp.select_smem(p, s, c, h1, h2, 32, rows, resident, dtype, "bisect") == first
        exact = cp.select_smem(p, s, c, h1, h2, 32, rows, resident, dtype, "exact")
        assert exact - first == u_diff
    assert ({l[:2] for l in cp.tile_layouts(p, s, c, h1, h2, 32, dtype, "exact")}
            <= {l[:2] for l in cp.tile_layouts(p, s, c, h1, h2, 32, dtype, "first")})


def test_all_plan_cuts_rows_by_the_budget():
    rng = np.random.default_rng(23)
    p, budget = 256, 1024
    counts = rng.integers(0, p + 1, 300).tolist()
    counts[7:12] = [0] * 5
    counts[40] = p
    groups = cp.all_groups(counts, budget)
    assert groups[0][0] == 0 and groups[-1][1] == len(counts)
    for (g0, g1), nxt in zip(groups, groups[1:] + [(len(counts), None)]):
        assert g1 > g0 and g1 == nxt[0]
        rows = sum(counts[g0:g1])
        assert rows <= budget
        assert g1 == len(counts) or rows + counts[g1] > budget    # the most that fit
    # A center of P rows a group, whole clouds in one where they fit.
    assert cp.all_groups([p] * 8, p) == [(i, i + 1) for i in range(8)]
    assert cp.all_groups([p] * 8, 4096) == [(0, 8)]
    # "all" takes tiles below K (centers are split across tiles) and only
    # budgets that hold a center's P rows.
    lay = cp.tile_layouts(300, 64, 64, 128, 128, 32, torch.bfloat16, "all")
    assert {b for *_, b in lay} == {4096, 2048, 1024, 512} and min(r for r, *_ in lay) == 16
    # Of equal rows in flight the largest budget; more blocks beat a budget.
    level = (256, 128, 3, 32, 64, 32, torch.bfloat16)
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 1, "all")
    assert (plan.rows, plan.resident, plan.budget) == (128, 1, 4096)
    plan = cp.pick_plan(*level, lambda rows, resident, smem, budget: 1 + (budget <= 1024),
                        "all")
    assert (plan.rows, plan.blocks_per_sm, plan.budget) == (128, 2, 1024)
