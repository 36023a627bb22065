"""The port's training SA level (ops/sa_train.py, models/pointnet2.py train
branch, models/mlp.py MaskedBatchNorm) against the JAX package's, on the CPU.

The JAX fused kernel runs in interpret mode (sa_train_fused with
interpret=True), as the JAX package's own tests run it; the JAX reference
sa_train_reference gives jax.grad gradients. Inputs are made with numpy.

Tolerances (f32): forward and statistics rtol 1e-5 / atol 1e-5 (sums in
another order); gradients rtol 5e-4 / atol 2.5e-3 (the JAX kernel test's:
db2 is near zero by BN shift invariance, so accumulation-order noise of
large intermediate sums dominates it). bf16: 2e-2 x max|want| (rounding
points are the kernel's, sums in another order). Modules: the JAX test's
2e-4 / 2e-5 forward and 5e-4 / 1e-3 gradients (the XLA path takes the
two-pass variance, the fused level the one-pass one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.models.mlp import MaskedBatchNorm as JaxMaskedBatchNorm
from text2loc_tpu.models.pointnet2 import SetAbstraction as JaxSetAbstraction
from text2loc_tpu.ops.pallas_sa_train import sa_train_fused, sa_train_reference
from text2loc_tpu_torch.convert import convert_tree
from text2loc_tpu_torch.models.mlp import MaskedBatchNorm
from text2loc_tpu_torch.models.pointnet2 import SetAbstraction
from text2loc_tpu_torch.ops.fps import fps_gather
from text2loc_tpu_torch.ops.sa_train import (sa_train, sa_train_backward_plain,
                                             sa_train_plain)

DIFF = ("u", "sv", "w2", "b2", "g1", "be1", "g2", "be2")


def _case(seed, n=4, p=16, s=8, k=4, h1=8, h2=16):
    """The JAX kernel test's case: ragged neighbour validity, one row
    without valid slots, the last object out of the statistics."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, p, h1)).astype(np.float32)
    sv = rng.standard_normal((n, s, h1)).astype(np.float32)
    w2 = (rng.standard_normal((h1, h2)) * 0.3).astype(np.float32)
    b2 = rng.standard_normal((h2,)).astype(np.float32)
    g1 = (1.0 + 0.1 * rng.standard_normal((h1,))).astype(np.float32)
    be1 = (0.1 * rng.standard_normal((h1,))).astype(np.float32)
    g2 = (1.0 + 0.1 * rng.standard_normal((h2,))).astype(np.float32)
    be2 = (0.1 * rng.standard_normal((h2,))).astype(np.float32)
    idx = rng.integers(0, p, size=(n, s, k)).astype(np.int32)
    maskm = rng.random((n, s, k)) < 0.8
    maskm[0, 0, :] = False
    obj = np.ones((n,), bool)
    obj[-1] = False
    maskf = maskm & obj[:, None, None]
    dout = rng.standard_normal((n, s, h2)).astype(np.float32)
    return (u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf), dout


CASES = {"ragged": dict(seed=0), "multi_tile": dict(seed=2, n=3, p=64, s=32, k=2, h1=8, h2=8)}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _jax_grads(fn, args, dout):
    def loss(*d):
        out, _ = fn(*d, *args[8:])
        return jnp.sum(out * dout)
    return jax.grad(loss, argnums=tuple(range(8)))(*(jnp.asarray(a) for a in args[:8]))


def _jax_fused(dtype):
    return functools.partial(sa_train_fused, compute_dtype=dtype, interpret=True)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_stats_match_jax(case):
    args, _ = _case(**CASES[case])
    out, stats = sa_train_plain(*(_t(a) for a in args))
    for ref in (_jax_fused(jnp.float32), sa_train_reference):
        want_out, want_stats = ref(*(jnp.asarray(a) for a in args))
        _close(out.numpy(), want_out, 1e-5, 1e-5, "out")
        for g, w in zip(stats, want_stats):
            _close(g.numpy(), w, 1e-5, 1e-5, "stats")
    assert (out[0, 0] == 0).all()           # the row without valid slots


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    """Autograd of the plain forward, the autograd function (whose CPU
    backward is the hand-derived sa_train_backward_plain), and the plain
    backward called directly, against jax.grad of the interpret kernel and
    of the reference."""
    args, dout = _case(**CASES[case])
    want = [_jax_grads(_jax_fused(jnp.float32), args, dout),
            _jax_grads(sa_train_reference, args, dout)]

    diff = [_t(a, grad=True) for a in args[:8]]
    out, _ = sa_train_plain(*diff, *(_t(a) for a in args[8:]))
    (out * _t(dout)).sum().backward()
    autograd = [d.grad.numpy() for d in diff]

    diff = [_t(a, grad=True) for a in args[:8]]
    out, _ = sa_train(*diff, *(_t(a) for a in args[8:]))
    (out * _t(dout)).sum().backward()
    function = [d.grad.numpy() for d in diff]

    for got in (autograd, function):
        for w in want:
            for name, g, ww in zip(DIFF, got, w):
                _close(g, ww, 5e-4, 2.5e-3, name)


def _aux_of(args, stats, eps=1e-5):
    """The forward's aux rows, from its statistics."""
    u, sv, w2, b2, g1, be1, g2, be2 = (_t(a) for a in args[:8])
    m1, v1, m2, v2, n1 = stats
    aux1 = torch.zeros(8, u.shape[-1])
    aux2 = torch.zeros(8, w2.shape[1])
    for aux, m, v, g, be in ((aux1, m1, v1, g1, be1), (aux2, m2, v2, g2, be2)):
        inv = torch.rsqrt(v + eps)
        aux[0], aux[1], aux[2], aux[3] = g * inv, be - m * g * inv, m, inv
    aux2[6] = b2
    return aux1, aux2, n1


def test_hand_derived_backward_matches_jax_kernel():
    args, dout = _case(**CASES["ragged"])
    _, stats = sa_train_plain(*(_t(a) for a in args))
    aux1, aux2, n1 = _aux_of(args, stats)
    got = sa_train_backward_plain(_t(args[0]), _t(args[1]), _t(args[2]), _t(args[8]),
                                  _t(args[9]), _t(args[10]), aux1, aux2, n1, _t(dout))
    for w in (_jax_grads(_jax_fused(jnp.float32), args, dout),
              _jax_grads(sa_train_reference, args, dout)):
        for name, g, ww in zip(DIFF, got, w):
            _close(g.numpy(), ww, 5e-4, 2.5e-3, name)


def test_bf16_compute_matches_interpret_kernel_in_bf16():
    """bf16 compute dtype: rounding of u before the gather, h1 before @W2,
    dz and h1 before the backward products, de before the scatter."""
    args, dout = _case(5, n=4, p=32, s=8, k=8, h1=16, h2=32)
    want_out, want_stats = _jax_fused(jnp.bfloat16)(*(jnp.asarray(a) for a in args))
    want_grads = _jax_grads(_jax_fused(jnp.bfloat16), args, dout)
    diff = [_t(a, grad=True) for a in args[:8]]
    out, stats = sa_train(*diff, *(_t(a) for a in args[8:]), compute_dtype=torch.bfloat16)
    (out * _t(dout)).sum().backward()
    for got, want, name in [(out.detach(), want_out, "out")] + [
            (g, w, f"stat{i}") for i, (g, w) in enumerate(zip(stats, want_stats))] + [
            (d.grad, w, name) for d, w, name in zip(diff, want_grads, DIFF)]:
        want = np.asarray(want, np.float32)
        err = np.abs(got.numpy() - want).max()
        assert err <= 2e-2 * max(np.abs(want).max(), 1e-3), (name, err)


def test_cache_dtype_f32_is_the_same_function_and_bf16_is_not_ported():
    """cache_dtype float32 is the recompute function; bfloat16 (the token
    "e", ported since) is another function that runs; other dtypes raise."""
    args, _ = _case(**CASES["ragged"])
    targs = [_t(a) for a in args]
    a, _ = sa_train(*targs)
    b, _ = sa_train(*targs, cache_dtype=torch.float32)
    assert torch.equal(a, b)
    c, _ = sa_train(*targs, cache_dtype=torch.bfloat16)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        sa_train(*targs, cache_dtype=torch.float16)


def _jax_fused_e(dtype):
    return functools.partial(sa_train_fused, compute_dtype=dtype, interpret=True,
                             cache_dtype=jnp.bfloat16)


# The bf16 edge cache: both sides round the same f32 e to bf16, so the
# forward and statistics keep the f32 tolerances of the recompute tests;
# in bf16 compute, 2e-2 x max|want| as test_bf16_compute_matches_....
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_cache_matches_interpret_kernel(case, compute):
    """sa_train(cache_dtype=bf16): forward, statistics and the eight
    gradients of the autograd function (the hand-derived plain backward on
    the CPU) and of autograd through the plain forward, against the JAX
    kernel's _forward_e / _backward_e in interpret mode."""
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    args, dout = _case(**CASES[case])
    want_out, want_stats = _jax_fused_e(jdt)(*(jnp.asarray(a) for a in args))
    want_grads = _jax_grads(_jax_fused_e(jdt), args, dout)

    def check(got, want, name, grad):
        want = np.asarray(want, np.float32)
        if compute == "bfloat16":
            err = np.abs(np.asarray(got, np.float32) - want).max()
            assert err <= 2e-2 * max(np.abs(want).max(), 1e-3), (name, err)
        elif grad:
            _close(got, want, 5e-4, 2.5e-3, name)
        else:
            _close(got, want, 1e-5, 1e-5, name)

    for fn in (sa_train, sa_train_plain):
        diff = [_t(a, grad=True) for a in args[:8]]
        out, stats = fn(*diff, *(_t(a) for a in args[8:]), compute_dtype=tdt,
                        cache_dtype=torch.bfloat16)
        (out * _t(dout)).sum().backward()
        check(out.detach().numpy(), want_out, "out", False)
        for i, (g, w) in enumerate(zip(stats, want_stats)):
            check(g.detach().numpy(), w, f"stat{i}", False)
        for name, d, w in zip(DIFF, diff, want_grads):
            check(d.grad.numpy(), w, name, True)


def test_bf16_cache_hand_derived_backward_matches_jax_kernel():
    """sa_train_backward_plain(cache_dtype=bf16) called directly, against
    the VJP of the JAX kernel's cached-edge path (f32 compute)."""
    args, dout = _case(**CASES["multi_tile"])
    _, stats = sa_train_plain(*(_t(a) for a in args), cache_dtype=torch.bfloat16)
    aux1, aux2, n1 = _aux_of(args, stats)
    got = sa_train_backward_plain(_t(args[0]), _t(args[1]), _t(args[2]), _t(args[8]),
                                  _t(args[9]), _t(args[10]), aux1, aux2, n1, _t(dout),
                                  cache_dtype=torch.bfloat16)
    for name, g, w in zip(DIFF, got, _jax_grads(_jax_fused_e(jnp.float32), args, dout)):
        _close(g.numpy(), w, 5e-4, 2.5e-3, name)


def _sa_case():
    rng = np.random.default_rng(5)
    n, p, c = 6, 32, 5
    x = rng.random((n, p, c)).astype(np.float32)
    pos = rng.random((n, p, 3)).astype(np.float32)
    obj_mask = np.array([True] * (n - 1) + [False])
    centers = fps_gather(torch.from_numpy(pos), 16)[0].numpy()
    return x, pos, obj_mask, centers


@pytest.mark.parametrize("port_fused", [True, False])
@pytest.mark.parametrize("jax_fused", [True, False])
def test_set_abstraction_train_matches_jax(port_fused, jax_fused):
    """Output, updated running statistics and the gradients of the
    parameters and of x, port (fused or plain path) against JAX (the
    interpret kernel or the XLA path), with the same exact neighbours."""
    x, pos, obj_mask, centers = _sa_case()
    jmod = JaxSetAbstraction(num_samples=16, radius=0.4, mlp_channels=(8, 8, 16),
                             max_neighbors=8, fused="off", fused_train=jax_fused,
                             fused_interpret=True)
    jargs = (jnp.asarray(pos), jnp.asarray(obj_mask))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), *jargs, train=True,
                          centers=jnp.asarray(centers))

    def run(params, xx):
        (out, _), upd = jmod.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   xx, *jargs, train=True, centers=jnp.asarray(centers),
                                   mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, upd["batch_stats"])

    (_, (want_out, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    mod = SetAbstraction(16, 0.4, (8, 8, 16), 8, fused_train=port_fused).train()
    mod.load_state_dict(convert_tree(variables["params"], variables["batch_stats"]))
    tx = _t(x, grad=True)
    out = mod(tx, _t(pos), _t(centers), _t(obj_mask))
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want_out, 2e-4, 2e-5, "out")
    want_state = convert_tree({}, want_stats)
    for key, val in want_state.items():
        _close(mod.state_dict()[key].numpy(), val.numpy(), 2e-4, 2e-5, key)
    want_grads = convert_tree(want_gp, {})
    for name, prm in mod.named_parameters():
        _close(prm.grad.numpy(), want_grads[name].numpy(), 5e-4, 1e-3, name)
    _close(tx.grad.numpy(), want_gx, 5e-4, 1e-3, "x")


def test_set_abstraction_train_e_token_matches_jax():
    """A SetAbstraction train step with the token "e" (the bf16 edge cache)
    against the JAX module with fused_train="e" and the interpret kernel:
    output, running statistics, the parameters' and x's gradients."""
    x, pos, obj_mask, centers = _sa_case()
    jmod = JaxSetAbstraction(num_samples=16, radius=0.4, mlp_channels=(8, 8, 16),
                             max_neighbors=8, fused="off", fused_train="e",
                             fused_interpret=True)
    jargs = (jnp.asarray(pos), jnp.asarray(obj_mask))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), *jargs, train=True,
                          centers=jnp.asarray(centers))

    def run(params, xx):
        (out, _), upd = jmod.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   xx, *jargs, train=True, centers=jnp.asarray(centers),
                                   mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, upd["batch_stats"])

    (_, (want_out, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    mod = SetAbstraction(16, 0.4, (8, 8, 16), 8, fused_train="e").train()
    mod.load_state_dict(convert_tree(variables["params"], variables["batch_stats"]))
    tx = _t(x, grad=True)
    out = mod(tx, _t(pos), _t(centers), _t(obj_mask))
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want_out, 2e-4, 2e-5, "out")
    for key, val in convert_tree({}, want_stats).items():
        _close(mod.state_dict()[key].numpy(), val.numpy(), 2e-4, 2e-5, key)
    want_grads = convert_tree(want_gp, {})
    for name, prm in mod.named_parameters():
        _close(prm.grad.numpy(), want_grads[name].numpy(), 5e-4, 1e-3, name)
    _close(tx.grad.numpy(), want_gx, 5e-4, 1e-3, "x")


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batchnorm_train_matches_jax(masked):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((6, 5, 12)) * 2 + 0.5).astype(np.float32)
    mask = rng.random((6, 5)) > 0.3 if masked else None
    jbn = JaxMaskedBatchNorm(12)
    jm = None if mask is None else jnp.asarray(mask)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jm, train=True)
    params = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(12), jnp.float32),
              "bias": jnp.asarray(0.1 * rng.standard_normal(12), jnp.float32)}
    stats = {"mean": jnp.asarray(0.1 * rng.standard_normal(12), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 1.5, 12), jnp.float32)}
    del variables

    def run(p, xx):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, mask=jm, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y)), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = MaskedBatchNorm(12).train()
    bn.load_state_dict(convert_tree(params, stats))
    tx = _t(x, grad=True)
    y = bn(tx, None if mask is None else _t(mask))
    torch.sin(y).sum().backward()
    _close(y.detach().numpy(), want_y, 1e-5, 1e-5, "y")
    _close(bn.running_mean.numpy(), want_stats["mean"], 1e-5, 1e-6, "mean")
    _close(bn.running_var.numpy(), want_stats["var"], 1e-5, 1e-6, "var")
    _close(bn.weight.grad.numpy(), gp["scale"], 1e-4, 1e-5, "scale")
    _close(bn.bias.grad.numpy(), gp["bias"], 1e-4, 1e-5, "bias")
    _close(tx.grad.numpy(), gx, 1e-4, 1e-5, "x")
