"""The feed-forward block above d=256 (ops/ffn.py's plain stages,
ops/cuda_ffn.py's route) against the JAX package.

- ffn_addln_plain against the Pallas kernel fused_ffn_addlayernorm in
  interpret mode at the tiled route's widths (D=1024/F=4096, the E=1024
  language trunk, and D=512/F=2048), with rows not a multiple of 16: ATOL
  in f32; in bf16 one bf16 ulp of max|want| (the two sum the products in
  another order, which can round the bf16 hidden the other way).
- Each plain stage (hidden, out + LayerNorm) in f32 against the same step
  written in jnp after ffn_addlayernorm_reference, at 1e-5 x max|ref|.
- The route: the fused kernel for the smoke's d <= 256 shapes, the tiled
  chain above, a raise where D or F is not a multiple of 128, and no
  feed-forward shape of Config()'s models refused under fused_ffn "1" or
  "all"; the fused kernel's layout summed by hand, and its plan
  (cuda_ffn.fused_plan) at every fused shape of Config() and every row
  count to 20,000.
- A model: the small test config with a 512-wide language trunk (the
  chain's width), every block on its fused function (fused_ffn="all",
  fused_attn="all"), against the JAX model's stock path on the same
  converted weights, f32, at the model tests' atol 1e-5.

The kernels themselves run only on the card: tests/test_torch_port_cuda.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.ops.pallas_ffn import fused_ffn_addlayernorm
from text2loc_tpu.training import steps
from text2loc_tpu_torch.config import Config
from text2loc_tpu_torch.convert import build_model, from_jax_params
from text2loc_tpu_torch.data.batch import TextSet
from text2loc_tpu_torch.models import transformer
from text2loc_tpu_torch.models.transformer import fused_ffn_enabled
from text2loc_tpu_torch.ops import cuda_ffn
from text2loc_tpu_torch.ops.ffn import (ffn_addln, ffn_addln_plain, ffn_hidden_plain,
                                        ffn_out_addln_plain)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, rows, d, f):
    """numpy f32 x [rows, D], w1 [D, F], b1, w2 [F, D], b2, LN scale/bias."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, d)).astype(np.float32),
            (rng.normal(size=(d, f)) / math.sqrt(d)).astype(np.float32),
            (0.1 * rng.normal(size=f)).astype(np.float32),
            (rng.normal(size=(f, d)) / math.sqrt(f)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32))


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.mark.parametrize("dtype,rows,d,f", [
    (torch.float32, 37, 1024, 4096),
    (torch.bfloat16, 37, 1024, 4096),
    (torch.float32, 23, 512, 2048),
    (torch.bfloat16, 23, 512, 2048),
])
def test_ffn_plain_matches_pallas_kernel_above_d256(dtype, rows, d, f):
    x, w1, b1, w2, b2, scale, bias = _inputs(5, rows, d, f)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = fused_ffn_addlayernorm(jnp.asarray(x).astype(jdt),
                                  *(jnp.asarray(a) for a in (w1, b1, w2, b2, scale, bias)),
                                  interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    args = (_t(x).to(dtype), *(_t(a) for a in (w1, b1, w2, b2, scale, bias)))
    got = ffn_addln_plain(*args)
    assert got.dtype == dtype and got.shape == (rows, d)
    atol = ATOL if dtype == torch.float32 else _bf16_ulp(float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    np.testing.assert_array_equal(ffn_addln(*args).float().numpy(), got.float().numpy())


def _close_rel(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("rows,d,f", [(37, 1024, 4096), (23, 512, 2048)])
def test_plain_stages_match_jnp_steps(rows, d, f):
    """Each stage on the same numpy inputs as the jnp step of
    ffn_addlayernorm_reference (text2loc_tpu/ops/pallas_ffn.py:91-102), f32."""
    x, w1, b1, w2, b2, scale, bias = _inputs(6, rows, d, f)
    hp = jax.lax.Precision.HIGHEST
    # (a) the hidden.
    jh = jnp.maximum(jnp.dot(x, w1, precision=hp) + b1, 0)
    _close_rel(ffn_hidden_plain(_t(x), _t(w1), _t(b1)), jh)
    # (b) + (c) the second product, residual and LayerNorm on the same h.
    nh = np.asarray(jh)
    s = x + (jnp.dot(nh, w2, precision=hp) + b2)
    mu = jnp.mean(s, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(s - mu), axis=-1, keepdims=True)
    jy = (s - mu) * jax.lax.rsqrt(var + 1e-5) * scale + bias
    y = ffn_out_addln_plain(_t(nh), _t(x), _t(w2), _t(b2), _t(scale), _t(bias))
    _close_rel(y, jy)


# (D, F) of chip_smoke.py's fused cases: the CCT, obj_inter, the inter head.
SMOKE_FUSED = [(128, 512), (256, 512), (256, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_the_fused_kernel_to_d256_and_the_tiled_chain_above(dtype):
    for d, f in SMOKE_FUSED:
        assert cuda_ffn.route(d, f, dtype) == "fused"
    assert cuda_ffn.route(1024, 4096, dtype) == "tiled"
    cuda_ffn.check_tiled(1024, 4096, dtype)
    assert cuda_ffn.route(512, 2048, dtype) == "tiled"
    # d <= 256 whose hidden rows exceed a block's shared memory.
    assert cuda_ffn.route(256, 8192, dtype) == "tiled"
    cuda_ffn.check_tiled(256, 8192, dtype)


def test_fused_smem_is_make_layouts_sum():
    """The Python sum of layout() (csrc/ffn_addln.cu) by hand: the x rows
    and the block's hidden slice in the dtype (rows padded by 16 bytes), the
    f32 rows of the block's output columns from each block of the cluster
    (padded by 4 floats), two f32 row statistics from each block, and the
    ring of 3 weight chunks of 16 x (256 + 4) f32. A 16-row block of C = 1 fits at D=1024 in neither
    dtype (the tiled chain's width)."""
    ring = 3 * 16 * 260 * 4
    assert cuda_ffn.fused_smem(1024, 4096, torch.bfloat16) == (
        2 * 16 * 1032 + 2 * 16 * 4104 + 4 * 16 * 1028 + 8 * 16 + ring) == 280192
    assert cuda_ffn.fused_smem(1024, 4096, torch.float32) == (
        4 * 16 * 1028 + 4 * 16 * 4100 + 4 * 16 * 1028 + 8 * 16 + ring) == 444032
    assert cuda_ffn.fused_smem(128, 512, torch.float32) == (
        4 * 16 * 132 + 4 * 16 * 516 + 4 * 16 * 132 + 8 * 16 + ring)
    # A batch-1 request's inter head: a cluster of 8 blocks, each with 128
    # hidden and 32 output columns.
    assert cuda_ffn.fused_smem(256, 1024, torch.bfloat16, 16, 8) == (
        2 * 16 * 264 + 2 * 16 * 136 + 4 * 8 * 16 * 36 + 8 * 8 * 16 + ring)
    # The smoke's CCT rows in bf16: C = 1, 80-row tiles.
    assert cuda_ffn.fused_smem(128, 512, torch.bfloat16, 80, 1) == (
        2 * 80 * 136 + 2 * 80 * 520 + 4 * 80 * 132 + 8 * 80 + ring)


SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plan_invariants(dtype):
    """At every feed-forward shape of Config()'s models that the fused route
    takes, at every row count from 1 to 20,000 on a 132-SM card: the cluster
    C is 1, 2, 4, 8 or 16 (16 only for one tile) and divides F into slices
    of a multiple of 16 (and D into multiples of 8); the layout is
    fused_smem's and fits a block's shared memory; a tile is 16-80 rows, a
    multiple of 16, and the tiles cover the rows; where C > 1 the blocks are
    at most one wave, or C is the fewest blocks whose layout takes the tile;
    route is the same whatever the rows. A batch-1 request's coarse inter
    head (6 rows) takes one tile on 16 blocks, its CCT calls (60, 160 rows)
    clusters of 8 blocks; the smoke's 10,240 CCT rows take 80-row tiles, on
    one block in bf16 and on two in f32 (whose hidden does not fit one)."""
    from text2loc_tpu_torch.ops import _cuda

    shapes = set()
    with torch.device("meta"):
        for kind in ("coarse", "fine"):
            for mod in build_model(Config(), kind).modules():
                if isinstance(mod, (transformer.EncoderLayer, transformer.DecoderLayer)):
                    shapes.add(tuple(mod.linear1.weight.shape))
    fused = {s for s in shapes if cuda_ffn.route(*s, dtype) == "fused"}
    assert fused == {(128, 512), (256, 512), (256, 1024)}
    for d, f in fused:
        for rows in range(1, 20001):
            p = cuda_ffn.fused_plan(rows, d, f, dtype, sms=SMS)
            assert p.cluster in (1, 2, 4, 8) or (p.cluster == 16 and rows <= 16)
            assert f % (16 * p.cluster) == 0 and d % (8 * p.cluster) == 0
            assert p.smem == cuda_ffn.fused_smem(d, f, dtype, p.rows, p.cluster)
            assert p.smem <= _cuda.SMEM_LIMIT
            assert 16 <= p.rows <= 80 and p.rows % 16 == 0
            assert p.blocks == -(-rows // p.rows) * p.cluster
            assert p.cluster == 1 or p.blocks <= SMS or cuda_ffn.fused_smem(
                d, f, dtype, p.rows, p.cluster // 2) > _cuda.SMEM_LIMIT
        assert cuda_ffn.route(d, f, dtype) == "fused"
        for rows in (1, 6):
            p = cuda_ffn.fused_plan(rows, d, f, dtype, sms=SMS)
            assert (p.rows, p.cluster, p.blocks) == (16, 16, 16)
        for rows in (60, 160):
            p = cuda_ffn.fused_plan(rows, d, f, dtype, sms=SMS)
            assert (p.rows, p.cluster, p.blocks) == (16, 8, 8 * -(-rows // 16))
    p = cuda_ffn.fused_plan(10240, 128, 512, dtype, sms=SMS)
    assert (p.rows, p.cluster) == (80, 1 if dtype == torch.bfloat16 else 2)
    assert cuda_ffn.fused_plan(16, 1024, 4096, dtype, sms=SMS) is None


def test_check_tiled_raises_off_the_128_grid():
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="multiples of 128"):
            cuda_ffn.check_tiled(320, 1280, dtype)
        with pytest.raises(ValueError, match="multiples of 128"):
            cuda_ffn.check_tiled(512, 2000, dtype)
    assert cuda_ffn.route(320, 1280, torch.bfloat16) == "tiled"


@pytest.mark.parametrize("value", ["1", "all"])
def test_no_ffn_shape_of_the_default_config_is_refused(value):
    """Every feed-forward block of Config()'s two models (built on the meta
    device), in both dtypes: where the gate opens, the routed kernel takes
    the shape; the E=1024 trunk reaches the chain under "all" alone."""
    blocks = set()
    with torch.device("meta"):
        for kind in ("coarse", "fine"):
            for mod in build_model(Config(), kind).modules():
                if isinstance(mod, (transformer.EncoderLayer, transformer.DecoderLayer)):
                    blocks.add(tuple(mod.linear1.weight.shape))
    assert (1024, 4096) in blocks
    tiled = set()
    for d, f in blocks:
        if not (d % 128 == 0 and f % 128 == 0 and fused_ffn_enabled(d, value)):
            continue
        for dtype in (torch.float32, torch.bfloat16):
            if cuda_ffn.route(d, f, dtype) == "tiled":
                cuda_ffn.check_tiled(d, f, dtype)
                tiled.add((d, dtype))
    assert tiled == ({(1024, torch.float32), (1024, torch.bfloat16)} if value == "all"
                     else set())


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if str(path[-1].key).endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def test_language_trunk_at_the_chains_width_matches_jax(small_cfg, small_data, monkeypatch):
    """The coarse text tower with a 512-wide intra stack (F=2048, the tiled
    route's width) built with fused_ffn="all", fused_attn="all": on the CPU
    every block runs its fused function's plain version; the JAX model
    runs its stock path. Same converted weights, f32."""
    m = dataclasses.replace(small_cfg.model, text_embed_dim=512)
    cfg = small_cfg.replace(model=m)
    jemb = JaxEmbedder.compositional(embed_dim=512, max_tokens=m.max_hint_tokens)
    rng = jax.random.PRNGKey(0)
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        small_data.gather_coarse(np.arange(6), m.object_size), jemb, cfg, rng, train=False)
    st = steps.init_train_state(cm, steps.make_optimizer(cfg, 1), rng, cobj, ctext)
    stats = _random_stats(st.batch_stats, 9)
    want = cm.apply({"params": st.params, "batch_stats": stats}, ctext,
                    method=cm.encode_text)

    model = build_model(cfg, "coarse", sa_mode="off", fused_ffn="all", fused_attn="all")
    model.load_state_dict(from_jax_params(jax.device_get(st.params), jax.device_get(stats),
                                          cfg, "coarse"))
    widths = []
    real = transformer.ffn_addln

    def counted(x, w1, *args, **kw):
        widths.append(tuple(w1.shape))
        return real(x, w1, *args, **kw)

    monkeypatch.setattr(transformer, "ffn_addln", counted)
    text = TextSet(*(_t(a) for a in ctext))
    with torch.no_grad():
        got = model.eval().encode_text(text)
    assert (512, 2048) in widths and cuda_ffn.route(512, 2048, torch.float32) == "tiled"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
