"""The port's model modules against the JAX package's, on weights carried
over with text2loc_tpu_torch.convert, at small widths in f32.

Tolerances: atol 1e-5 on activations (f32 sums taken in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu import constants as C
from text2loc_tpu.models import pointnet2 as jpn
from text2loc_tpu.models.transformer import TorchDecoderLayer, TorchEncoderLayer
from text2loc_tpu_torch.convert import build_model, convert_tree, init_weights
from text2loc_tpu_torch.models.pointnet2 import PointNet2
from text2loc_tpu_torch.models.transformer import DecoderLayer, EncoderLayer

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _random_stats(stats, seed):
    """BN running statistics away from 0/1, made with numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.mark.parametrize("mode,fused", [("first", "first"), ("exact", False)])
def test_pointnet2_matches_jax(small_cfg, mode, fused):
    """"first": the port's plain SA level vs the Pallas kernel in interpret
    mode; "exact": the port's nearest-K path vs the JAX XLA path."""
    pcfg = small_cfg.model.pointnet
    rng = np.random.default_rng(0)
    xyz = rng.random((6, pcfg.num_points, 3)).astype(np.float32)
    rgb = rng.random((6, pcfg.num_points, 3)).astype(np.float32)
    jmod = jpn.PointNet2(pcfg, num_classes=C.NUM_CLASSES, num_colors=C.NUM_COLORS,
                         fused=fused, fused_interpret=True)
    variables = jax.jit(functools.partial(jmod.init, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(xyz), jnp.asarray(rgb))
    stats = _random_stats(variables["batch_stats"], 2)
    want = jmod.apply({"params": variables["params"], "batch_stats": stats},
                      jnp.asarray(xyz), jnp.asarray(rgb), train=False)

    port = PointNet2(pcfg, C.NUM_CLASSES, C.NUM_COLORS, sa_mode=mode).eval()
    port.load_state_dict(convert_tree(variables["params"], stats))
    with torch.no_grad():
        got = port(_t(xyz), _t(rgb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def _layer_case(jlayer, port_layer, seed, args_np, **call_kw):
    variables = jax.jit(functools.partial(jlayer.init, train=False, **call_kw))(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in args_np))
    want = jlayer.apply(variables, *(jnp.asarray(a) for a in args_np), train=False,
                        **call_kw)
    port_layer.load_state_dict(convert_tree(variables["params"], {}))
    return np.asarray(want), port_layer.eval()


@pytest.mark.parametrize("d", [32, 128])   # stock ops / the fused blocks' path
def test_encoder_layer_matches_jax(d):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, d)).astype(np.float32)
    mask = rng.random((5, 7)) > 0.3
    mask[:, 0] = True
    want, layer = _layer_case(TorchEncoderLayer(d, 4, 2 * d), EncoderLayer(d, 4, 2 * d),
                              4, (x, mask))
    with torch.no_grad():
        got = layer(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stage", ["full", "self", "rest"])
def test_decoder_layer_matches_jax(stage):
    d = 128
    rng = np.random.default_rng(5)
    tgt = rng.normal(size=(4, 6, d)).astype(np.float32)
    mem = rng.normal(size=(4, 9, d)).astype(np.float32)
    tm = rng.random((4, 6)) > 0.3
    mm = rng.random((4, 9)) > 0.3
    tm[:, 0] = mm[:, 0] = True
    jlayer = TorchDecoderLayer(d, 4, 4 * d)
    variables = jax.jit(functools.partial(jlayer.init, train=False))(
        jax.random.PRNGKey(6), jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(tm),
        jnp.asarray(mm))
    want = jlayer.apply(variables, jnp.asarray(tgt), jnp.asarray(mem),
                        jnp.asarray(tm), jnp.asarray(mm), train=False, stage=stage)
    layer = DecoderLayer(d, 4, 4 * d).eval()
    layer.load_state_dict(convert_tree(variables["params"], {}))
    with torch.no_grad():
        got = layer(_t(tgt), _t(mem), _t(tm), _t(mm), stage=stage)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_cct_factorization_is_exact(small_cfg):
    """cct == cct_tail(cct_obj_pre, ..., cct_hints_pre): same blocks, same
    order."""
    model = init_weights(build_model(small_cfg, "fine"),
                         torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(7)
    d = small_cfg.model.fine_embed_dim
    obj = _t(rng.normal(size=(3, 6, d)).astype(np.float32))
    hints = _t(rng.normal(size=(3, 3, d)).astype(np.float32))
    om = _t(rng.random((3, 6)) > 0.3)
    sm = _t(np.array([[1, 1, 0], [1, 1, 1], [1, 0, 0]], bool))
    om[:, 0] = True
    with torch.no_grad():
        full = model.cct(obj, om, hints, sm)
        split = model.cct_tail(model.cct_obj_pre(obj, om), om, hints,
                               model.cct_hints_pre(hints, sm), sm)
    np.testing.assert_array_equal(split.numpy(), full.numpy())


def test_from_jax_params_rejects_a_tree_that_does_not_fit(small_cfg):
    from text2loc_tpu_torch.convert import from_jax_params

    state = build_model(small_cfg, "fine").state_dict()
    tree = {"mlp_offsets": {"dense_0": {"kernel": np.zeros((3, 3), np.float32)}}}
    with pytest.raises(ValueError, match="does not fit"):
        from_jax_params(tree, {}, small_cfg, "fine")
    assert "mlp_offsets.dense_0.weight" in state
