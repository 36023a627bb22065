"""The port's inference SA modes against the JAX package's.

Each plain version (the CPU path of its dispatch) is held against its
Pallas kernel run in interpret mode on the same numpy-seeded inputs, in
f32 at atol 1e-5 (f32 sums taken in another order): fused_sa_select with
bisect selection, fused_sa_gather fed the JAX ball query's neighbours, and
fused_set_abstraction with and without K selection. PointNet2 in every
fused mode is held against the JAX PointNet2 on converted weights; the
approximate ball query against JAX's by the rule of ops/ballquery.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu import constants as C
from text2loc_tpu.models import pointnet2 as jpn
from text2loc_tpu.ops.ballquery import ball_query_knn as jax_ball_query
from text2loc_tpu.ops.pallas_pointconv import (
    fused_sa_gather,
    fused_sa_select,
    fused_set_abstraction,
)
from text2loc_tpu_torch.convert import convert_tree
from text2loc_tpu_torch.models.pointnet2 import PointNet2, sa_mode_list
from text2loc_tpu_torch.ops.ballquery import ball_query_knn
from text2loc_tpu_torch.ops.pointconv import (
    sa_gather,
    sa_gather_plain,
    sa_select_plain,
    set_abstraction,
    set_abstraction_plain,
)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _cloud(rng, kind, n, p):
    if kind == "voxel":
        # Coordinates on a 1/8 grid: every product and sum of d2 is exact in
        # f32, so both packages see the same tied distances.
        return (rng.integers(0, 9, (n, p, 3)) / 8.0).astype(np.float32)
    pos = rng.random((n, p, 3)).astype(np.float32)
    pos[:, 20:26] = pos[:, 0:6]                     # duplicate points
    return pos


def _sa_inputs(seed, kind="random", n=6, p=32, s=12, c=5, h1=16, h2=24):
    rng = np.random.default_rng(seed)
    x = rng.random((n, p, c)).astype(np.float32)
    pos = _cloud(rng, kind, n, p)
    centers = pos[:, :s].copy()
    centers[0, 3] = (5.0, 5.0, 5.0)                 # empty-radius row
    w1 = (rng.normal(size=(c + 3, h1)) / math.sqrt(c + 3)).astype(np.float32)
    w2 = (rng.normal(size=(h1, h2)) / math.sqrt(h1)).astype(np.float32)
    ab1 = np.stack([1 + 0.1 * rng.normal(size=h1), 0.1 * rng.normal(size=h1)])
    ab2 = np.stack([1 + 0.1 * rng.normal(size=h2), 0.1 * rng.normal(size=h2)])
    return dict(x=x, pos=pos, centers=centers, feat=np.concatenate([x, pos], -1),
                w1=w1, wx=w1[:c].copy(), wp=w1[c:].copy(), w2=w2,
                ab1=ab1.astype(np.float32), ab2=ab2.astype(np.float32))


def _args(a, names, conv):
    return tuple(conv(a[n]) for n in names)


SELECT = ("feat", "pos", "centers", "w1", "wp", "ab1", "w2", "ab2")
TAIL = ("w1", "wp", "ab1", "w2", "ab2")
SET_ABS = ("x", "pos", "centers", "wx", "wp", "ab1", "w2", "ab2")


@pytest.mark.parametrize("kind,radius,k,iters", [
    ("random", 0.45, 8, 12),       # dense: most centers see more than K
    ("voxel", 0.4, 8, 12),         # tied distances: the tie expansion
    ("voxel", 0.4, 8, 4),
    ("random", 0.15, 8, 12),       # sparse: fewer than K in radius
    ("random", 0.45, 8, 4),
])
def test_bisect_plain_matches_pallas_kernel(kind, radius, k, iters):
    a = _sa_inputs(3, kind)
    want = fused_sa_select(*_args(a, SELECT, jnp.asarray), radius=radius, k=k,
                           interpret=True, selection="bisect", bisect_iters=iters)
    got = sa_select_plain(*_args(a, SELECT, _t), radius, k, selection="bisect",
                          bisect_iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.all(got.numpy()[0, 3] == 0.0)         # empty row pools to 0


@pytest.mark.parametrize("approx", [False, True])
def test_gather_plain_matches_pallas_kernel(approx):
    a = _sa_inputs(4, "voxel" if approx else "random")
    idx, mask = jax_ball_query(jnp.asarray(a["pos"]), jnp.asarray(a["centers"]), 0.4, 8,
                               approx=approx)
    want = fused_sa_gather(jnp.asarray(a["feat"]), jnp.asarray(a["centers"]), idx, mask,
                           *_args(a, TAIL, jnp.asarray), interpret=True)
    args = (_t(a["feat"]), _t(a["centers"]), _t(idx).long(), _t(mask))
    got = sa_gather_plain(*args, *_args(a, TAIL, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(sa_gather(*args, *_args(a, TAIL, _t)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("select_k", [True, False])
def test_set_abstraction_plain_matches_pallas_kernel(select_k):
    a = _sa_inputs(5)
    want = fused_set_abstraction(*_args(a, SET_ABS, jnp.asarray), radius=0.45, k=8,
                                 interpret=True, select_k=select_k)
    got = set_abstraction_plain(*_args(a, SET_ABS, _t), 0.45, 8, select_k=select_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.all(got.numpy()[0, 3] == 0.0)
    np.testing.assert_array_equal(
        set_abstraction(*_args(a, SET_ABS, _t), 0.45, 8, select_k=select_k).numpy(),
        got.numpy())


def test_approx_ball_query_matches_jax_by_keys():
    """The same multiset of selected bf16 keys in every row, and the same
    index set wherever the K-th and (K+1)-th keys differ (JAX's CPU
    approx_max_k breaks ties in no fixed order)."""
    rng = np.random.default_rng(6)
    src = _cloud(rng, "voxel", 8, 48)
    query = src[:, :12].copy()
    k = 8
    want_idx, want_mask = jax_ball_query(jnp.asarray(src), jnp.asarray(query), 0.5, k,
                                         approx=True)
    idx, mask = ball_query_knn(_t(src), _t(query), 0.5, k, approx=True)
    want_idx, want_mask = np.asarray(want_idx), np.asarray(want_mask)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    d2 = ((query[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1)
    key = torch.from_numpy(np.where(d2 <= 0.25, -d2, -1e30).astype(np.float32))
    key = key.to(torch.bfloat16).float().numpy()                     # [N, Q, P]
    ties = 0
    for b in range(src.shape[0]):
        for q in range(query.shape[1]):
            m = mask.numpy()[b, q]
            got_keys = np.sort(key[b, q, idx.numpy()[b, q][m]])
            want_keys = np.sort(key[b, q, want_idx[b, q][m]])
            np.testing.assert_array_equal(got_keys, want_keys)
            ranked = np.sort(key[b, q])[::-1]
            if ranked[k - 1] != ranked[k]:
                assert set(idx.numpy()[b, q][m]) == set(want_idx[b, q][m])
            else:
                ties += 1
    assert ties > 0        # the grid makes ties at the K-th slot


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _jax_pointnet(pcfg, xyz, rgb, fused):
    jmod = jpn.PointNet2(pcfg, num_classes=C.NUM_CLASSES, num_colors=C.NUM_COLORS,
                         fused=fused, fused_interpret=True)
    variables = jax.jit(functools.partial(jmod.init, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(xyz), jnp.asarray(rgb))
    return jmod, variables["params"], _random_stats(variables["batch_stats"], 2)


def _clouds(pcfg, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.random((6, pcfg.num_points, 3)).astype(np.float32) * 0.5
    rgb = rng.random((6, pcfg.num_points, 3)).astype(np.float32)
    return xyz, rgb


@pytest.mark.parametrize("mode", ["full", "gather", "exact", "all"])
def test_pointnet2_mode_matches_jax(small_cfg, monkeypatch, mode):
    """The JAX PointNet2 with fused=mode runs its Pallas kernels in
    interpret mode. "gather" takes exact neighbours on both sides (the JAX
    package reads TEXT2LOC_APPROX_NEIGHBORS when it traces)."""
    monkeypatch.setenv("TEXT2LOC_APPROX_NEIGHBORS", "0")
    pcfg = small_cfg.model.pointnet
    xyz, rgb = _clouds(pcfg)
    jmod, params, stats = _jax_pointnet(pcfg, xyz, rgb, mode)
    want = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(xyz),
                      jnp.asarray(rgb), train=False)
    port = PointNet2(pcfg, C.NUM_CLASSES, C.NUM_COLORS, sa_mode=mode,
                     approx_neighbors=False).eval()
    port.load_state_dict(convert_tree(params, stats))
    with torch.no_grad():
        got = port(_t(xyz), _t(rgb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_per_level_modes_match_jax_levels(small_cfg):
    """sa_mode=("full", "full", "all"): each level of the port against the
    JAX SetAbstraction of that level's mode, on the level's own inputs."""
    pcfg = small_cfg.model.pointnet
    xyz, rgb = _clouds(pcfg, 1)
    _, params, stats = _jax_pointnet(pcfg, xyz, rgb, "off")
    port = PointNet2(pcfg, C.NUM_CLASSES, C.NUM_COLORS,
                     sa_mode=("full", "full", "all")).eval()
    port.load_state_dict(convert_tree(params, stats))
    seen = []
    hooks = [getattr(port, f"sa{i + 1}").register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp, out))) for i in range(3)]
    with torch.no_grad():
        port(_t(xyz), _t(rgb))
    for h in hooks:
        h.remove()
    assert [m.mode for m, _, _ in seen] == ["full", "full", "all"]
    for i, (mod, (x, pos, centers, _), out) in enumerate(seen):
        level = jpn.SetAbstraction(
            num_samples=pcfg.sa_num_points[i], radius=pcfg.sa_radii[i],
            mlp_channels=pcfg.sa_mlps[i], max_neighbors=pcfg.sa_max_neighbors,
            fused=mod.mode, fused_interpret=True)
        want, _ = level.apply(
            {"params": params[f"sa{i + 1}"], "batch_stats": stats[f"sa{i + 1}"]},
            jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()), train=False,
            centers=jnp.asarray(centers.numpy()))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_sa_mode_list_parses_and_rejects():
    assert sa_mode_list("first", 3) == ("first",) * 3
    assert sa_mode_list("full,full,all", 3) == ("full", "full", "all")
    assert sa_mode_list(" 1 , off ,gather", 3) == ("exact", "off", "gather")
    assert sa_mode_list(("all", "exact"), 2) == ("all", "exact")
    assert sa_mode_list("", 2) == ("off", "off")
    with pytest.raises(ValueError, match="expected 3 modes"):
        sa_mode_list("full,all", 3)
    with pytest.raises(ValueError, match="unknown mode"):
        sa_mode_list("frst", 3)
    with pytest.raises(ValueError, match="unknown mode"):
        sa_mode_list(("first", "first", "bisect"), 3)
