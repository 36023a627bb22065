"""The port's opt-in kernel paths against the JAX package's, on the CPU:
the add+LayerNorm block (ops/ln.py) and the transformer gates, the row
gather and its scatter-add backward (ops/gather.py, ops/ballquery.py), the
PointNet2 `vmem_gather` option, the stage auto of the training SA tokens,
and run_pipeline with the options open.

Inputs are made with numpy from a seed. The Pallas kernels run in
interpret mode, as the JAX package's own tests run them. Tolerances, each
with its reason:

* add+LN in f32: rtol 1e-6 / atol 1e-6 against the interpret kernel (the
  same function, sums in another order); in bf16 one bf16 ulp of the
  kernel's output (an f32 difference in the last bit can round the other
  way), and 4 ulps against add_layernorm_reference, which rounds x + res
  to bf16 before the statistics (the kernel sums in f32);
* gathers: bit-equal (a copy); the scatter-add within 1e-6 x max|want|
  (the same rows summed in another order: a point hit ~200 times sums ~200
  rows);
* layers and the pipeline in f32: the model tests' atol 1e-5, and the eval
  tests' equal tables and retrievals with positions within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu import constants as JC
from text2loc_tpu.config import Config as JaxConfig
from text2loc_tpu.evaluation import pipeline as jpipeline
from text2loc_tpu.models import transformer as jtransformer
from text2loc_tpu.models.cell_retrieval import CellRetrievalNetwork
from text2loc_tpu.models.cross_matcher import CrossMatch
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu.ops.ballquery import onehot_gather as jax_onehot_gather
from text2loc_tpu.ops.pallas_gather import gather_rows_grad as jax_gather_rows_grad
from text2loc_tpu.ops.pallas_gather import gather_rows_pallas
from text2loc_tpu.ops.pallas_ln import add_layernorm_reference, fused_add_layernorm
from text2loc_tpu.training import steps as jsteps
from text2loc_tpu_torch.config import Config
from text2loc_tpu_torch.convert import build_model, convert_tree, from_jax_params
from text2loc_tpu_torch.evaluation import pipeline
from text2loc_tpu_torch.models.pointnet2 import PointNet2, fused_train_list
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.models.transformer import (DecoderLayer, EncoderLayer, Gates,
                                                   fused_attn_enabled, fused_ffn_enabled,
                                                   fused_ln_enabled)
from text2loc_tpu_torch.ops import _cuda, cuda_ffn, cuda_ln, cuda_mha
from text2loc_tpu_torch.ops.ballquery import gather_neighbors, onehot_gather
from text2loc_tpu_torch.ops.gather import (gather_rows, gather_rows_grad,
                                           gather_rows_plain, scatter_rows_plain)
from text2loc_tpu_torch.ops.ln import add_layernorm, add_layernorm_plain
from text2loc_tpu_torch.training import steps as psteps

ATOL = 1e-5
POS_ATOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _ln_case(seed, rows, d, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 2 + 0.3).astype(np.float32)
    res = rng.normal(size=(rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    port = (torch.tensor(x).to(tdt), torch.tensor(res).to(tdt), torch.tensor(scale),
            torch.tensor(bias))
    jax_args = (jnp.asarray(x, jdt), jnp.asarray(res, jdt), jnp.asarray(scale),
                jnp.asarray(bias))
    return port, jax_args


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,rows", [(128, 37), (256, 600), (1024, 75), (384, 40), (768, 21),
                                    (2048, 9), (4096, 5)])
def test_add_layernorm_plain_matches_the_interpret_kernel(d, rows, dtype):
    port, jargs = _ln_case(d + rows, rows, d, dtype)
    got = add_layernorm_plain(*port).float().numpy()
    assert add_layernorm(*port).dtype == port[0].dtype
    kernel = np.asarray(fused_add_layernorm(*jargs, interpret=True), np.float32)
    ref = np.asarray(add_layernorm_reference(*jargs), np.float32)
    assert got.shape == kernel.shape == (rows, d)
    if dtype == "float32":
        np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - kernel) <= _bf16_ulp(kernel)).all()
        assert (np.abs(got - ref) <= 4 * _bf16_ulp(np.maximum(np.abs(ref), 1.0))).all()


def test_add_layernorm_rejects_a_mismatched_residual():
    port, _ = _ln_case(0, 4, 128, "float32")
    with pytest.raises(ValueError):
        add_layernorm(port[0], port[1].to(torch.bfloat16), *port[2:])


SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (128, 256, 512, 1024, 192, 384, 640, 768))
def test_row_plan_invariants(d, dtype):
    """cuda_ln.row_plan (the row LayerNorm of add_ln and of the tiled
    chains' last stage) at the add+LN widths and at other multiples of the
    chains' 128 grid, rows 1 to 30,000 on a 132-SM card: a row is lanes x
    chunks 16-byte chunks with fewer than half of them to spare; a half-warp
    owns a row of exactly 16 chunks (D=128 in bf16), two rows a warp, a
    whole warp any wider one; the blocks cover every row once, or fill
    per_sm blocks on every SM, per_sm by the values a lane keeps; and the
    grid-stride walk of the blocks' warps takes each row exactly once."""
    v = 8 if dtype == torch.bfloat16 else 4
    n = d // v
    for rows in range(1, 30001):
        p = cuda_ln.row_plan(rows, d, dtype, sms=SMS)
        assert (p.lanes == 16) == (n == 16) and p.lanes in (16, 32) and p.warps == 1
        assert p.chunks in (1, 2, 4, 8) and p.lanes * p.chunks >= n > p.lanes * p.chunks // 2
        assert p.rows_per_warp * p.lanes == 32
        values = p.chunks * v
        assert p.per_sm == (6 if values <= 8 else 5 if values <= 16
                            else 4 if p.chunks <= 4 else 3)
        need = -(-rows // (cuda_ln.WARPS * p.rows_per_warp))
        assert p.blocks == min(need, SMS * p.per_sm) >= 1
    if (d, dtype) == (128, torch.bfloat16):
        assert cuda_ln.row_plan(10240, d, dtype, sms=SMS)[:3] == (16, 1, 2)
    if d == 1024:
        assert cuda_ln.row_plan(25344, d, dtype, sms=SMS)[:3] == (32, 32 // v, 1)
    for rows in (1, 15, 16, 17, 1795, 3001, 10241, 25344, 100000):
        p = cuda_ln.row_plan(rows, d, dtype, sms=SMS)
        warps, rpw = p.blocks * cuda_ln.WARPS, p.rows_per_warp
        seen = np.zeros(rows, np.int64)
        for w in range(warps):
            for r0 in range(w * rpw, rows, warps * rpw):
                seen[r0:min(r0 + rpw, rows)] += 1
        assert (seen == 1).all()


def test_row_plan_refuses_what_the_routine_does_not_take():
    """Widths not a multiple of 16 bytes, of fewer than 16 chunks, or of
    more than 2048 (eight warps of eight chunks a lane) raise ValueError
    that names the limit; 257 to 2048 chunks take the wide layout."""
    for d, dtype in ((102, torch.float32), (132, torch.bfloat16), (64, torch.bfloat16),
                     (32, torch.float32), (8196, torch.float32), (8320, torch.float32),
                     (16392, torch.bfloat16), (16512, torch.bfloat16), (0, torch.float32)):
        with pytest.raises(ValueError, match="16-byte chunks"):
            cuda_ln.row_plan(16, d, dtype, sms=SMS)
    with pytest.raises(ValueError, match="D <= 8192 in f32, 16384 in bf16"):
        cuda_ln.row_plan(16, 8320, torch.float32, sms=SMS)
    assert cuda_ln.row_plan(16, 2048, torch.bfloat16, sms=SMS)[:2] == (32, 8)
    assert cuda_ln.row_plan(16, 1024, torch.float32, sms=SMS)[:2] == (32, 8)
    assert cuda_ln.row_plan(16, 1028, torch.float32, sms=SMS).warps == 2
    assert cuda_ln.row_plan(16, 2048, torch.float32, sms=SMS).warps == 2
    assert cuda_ln.row_plan(16, 4096, torch.bfloat16, sms=SMS).warps == 2
    assert cuda_ln.row_plan(16, 8192, torch.float32, sms=SMS).warps == 8
    assert cuda_ln.row_plan(16, 16384, torch.bfloat16, sms=SMS).warps == 8


def _parent_row_plan(rows, d, dtype, sms):
    """The row routine's plan before the wide layout, written out: widths
    of 16 to 256 chunks, a half-warp at 16, else a warp of 1-8 chunks a
    lane; (lanes, chunks, rows_per_warp, blocks, per_sm)."""
    v = 8 if dtype == torch.bfloat16 else 4
    n = d // v
    assert d % v == 0 and 16 <= n <= 256
    lanes = 16 if n == 16 else 32
    chunks = 1
    while lanes * chunks < n:
        chunks *= 2
    values = chunks * v
    per_sm = ((6 if values <= 8 else 5) if values <= 16
              else (4 if chunks <= 4 else 3) if values <= 32 else 2)
    rpw = 32 // lanes
    return lanes, chunks, rpw, min(-(-rows // (8 * rpw)), sms * per_sm), per_sm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_plan_is_the_parents_at_every_width_the_parent_took(dtype):
    """Every (rows, d, dtype) the routine planned before the wide layout
    keeps its plan: every width of 16 to 256 chunks, rows 1 to 40,000 and
    two card sizes; the wide layout's warps stay 1 there."""
    v = 8 if dtype == torch.bfloat16 else 4
    rows_set = sorted({*range(1, 300), *range(300, 40001, 97), 1584 * 16, 25344, 100000})
    for d in range(16 * v, 256 * v + 1, v):
        for sms in (132, 114):
            for rows in rows_set:
                p = cuda_ln.row_plan(rows, d, dtype, sms=sms)
                assert tuple(p[:5]) == _parent_row_plan(rows, d, dtype, sms), (d, rows)
                assert p.warps == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks_a_row", [257, 288, 512, 513, 640, 1024, 1025, 1536, 2048])
def test_row_plan_wide_layout_invariants(chunks_a_row, dtype):
    """Past 256 chunks a row (D > 1024 in f32, D > 2048 in bf16) the wide
    layout: a row over 2, 4 or 8 warps of 32 lanes and 8 chunks a lane,
    which cover the row with fewer than half the chunks to spare; a block
    takes 8 / warps rows at a time; per_sm by the registers; the blocks
    cover every row once or fill per_sm on every SM, and the block-wide
    grid-stride walk takes each row exactly once."""
    v = 8 if dtype == torch.bfloat16 else 4
    d = chunks_a_row * v
    n = chunks_a_row
    for rows in range(1, 20001, 7):
        p = cuda_ln.row_plan(rows, d, dtype, sms=SMS)
        assert (p.lanes, p.chunks, p.rows_per_warp) == (32, 8, 1)
        assert p.warps in (2, 4, 8)
        assert p.warps * 32 * p.chunks >= n > p.warps * 32 * p.chunks // 2
        assert p.per_sm == (3 if v == 4 else 2)
        need = -(-rows // (cuda_ln.WARPS // p.warps))
        assert p.blocks == min(need, SMS * p.per_sm) >= 1
    for rows in (1, 3, 4, 5, 1795, 3001, 10241, 25344, 100000):
        p = cuda_ln.row_plan(rows, d, dtype, sms=SMS)
        per_block = cuda_ln.WARPS // p.warps
        seen = np.zeros(rows, np.int64)
        for blk in range(p.blocks):
            for r0 in range(blk * per_block, rows, p.blocks * per_block):
                seen[r0:min(r0 + per_block, rows)] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_widths_past_the_row_routine_raise_before_any_launch(dtype):
    """add_layernorm_cuda, cuda_mha.check_tiled and cuda_ffn.check_tiled
    refuse D off the multiples of 128 and past the row routine's limit
    (8192 in f32, 16384 in bf16) with ValueError, before they look at a
    device; at the limit the widths pass (on CPU tensors the device check
    then refuses them)."""
    limit = 8192 if dtype == torch.float32 else 16384
    for d in (limit + 128, 2 * limit):
        x = torch.zeros(2, d, dtype=dtype)
        g = torch.zeros(d)
        with pytest.raises(ValueError, match="16-byte chunks"):
            cuda_ln.add_layernorm_cuda(x, x, g, g)
        with pytest.raises(ValueError, match="16-byte chunks"):
            cuda_mha.check_tiled(16, 16, d, d // 128, dtype)
        with pytest.raises(ValueError, match="16-byte chunks"):
            cuda_ffn.check_tiled(d, 4 * d, dtype)
    for d in (96, 192, 1000):
        x = torch.zeros(2, d, dtype=dtype)
        g = torch.zeros(d)
        with pytest.raises(ValueError, match="multiple of 128"):
            cuda_ln.add_layernorm_cuda(x, x, g, g)
        with pytest.raises(ValueError, match="multiple of 128"):
            cuda_mha.check_tiled(16, 16, d, 1, dtype)
        with pytest.raises(ValueError, match="multiples of 128"):
            cuda_ffn.check_tiled(d, 4 * 128, dtype)
    for d in (384, 768, 2048, 4096, limit):
        x = torch.zeros(2, d, dtype=dtype)
        g = torch.zeros(d)
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            cuda_ln.add_layernorm_cuda(x, x, g, g)
        cuda_ffn.check_tiled(d, 4 * d, dtype)
        cuda_mha.check_tiled(16, 16, d, d // 128, dtype)


def test_as_given_returns_a_ready_tensor_itself():
    """_cuda.as_given: the tensor itself where it is contiguous and in the
    dtype (no device op), a converted contiguous copy otherwise."""
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    assert _cuda.as_given(t, torch.float32) is t
    b = _cuda.as_given(t, torch.bfloat16)
    assert b is not t and b.dtype == torch.bfloat16 and torch.equal(b, t.to(torch.bfloat16))
    tt = t.t()
    c = _cuda.as_given(tt, torch.float32)
    assert c is not tt and c.is_contiguous() and torch.equal(c, tt)
    assert c.data_ptr() != t.data_ptr()


@pytest.mark.parametrize("value", ["0", "1", "all"])
def test_gates_match_the_jax_gates(monkeypatch, value):
    """Every (d, dtype) under each value of TEXT2LOC_FUSED_*, with the JAX
    backend taken for a TPU (the port has no backend check)."""
    monkeypatch.setattr(jtransformer.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("TEXT2LOC_DISABLE_PALLAS", raising=False)
    for var in ("TEXT2LOC_FUSED_LN", "TEXT2LOC_FUSED_FFN", "TEXT2LOC_FUSED_ATTN"):
        monkeypatch.setenv(var, value)
    for d in (32, 64, 128, 256, 384, 512, 1024, 2048):
        assert fused_ln_enabled(d, value) == jtransformer._fused_ln_enabled(d), d
        assert fused_ffn_enabled(d, value) == jtransformer._fused_ffn_enabled(d), d
        for tdt, jdt in DTYPES.values():
            assert (fused_attn_enabled(d, tdt, value)
                    == jtransformer._fused_attn_enabled(d, jdt)), (d, tdt)


def test_gates_reject_unknown_values():
    with pytest.raises(ValueError):
        Gates(ln="2")
    with pytest.raises(ValueError):
        build_model(Config(), "coarse", fused_ffn="yes")


def _t(a):
    return torch.tensor(np.asarray(a))


def _layer_params(jlayer, seed, args):
    return jax.jit(functools.partial(jlayer.init, train=False))(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("gates", [Gates(ffn="0"), Gates(attn="0"), Gates(attn="0", ffn="0")],
                         ids=["ffn0", "attn0", "both0"])
def test_layers_with_stock_blocks_and_the_ln_kernel_match_jax(gates):
    """At d=128 in eval, a gate "0" sends its block through stock ops and
    the add+LN block (plain version here); the JAX layers on the CPU run
    stock ops throughout. The same function in f32."""
    d = 128
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 7, d)).astype(np.float32)
    mem = rng.normal(size=(5, 9, d)).astype(np.float32)
    xm, mm = rng.random((5, 7)) > 0.3, rng.random((5, 9)) > 0.3
    xm[:, 0] = mm[:, 0] = True
    jenc = jtransformer.TorchEncoderLayer(d, 4, 2 * d)
    variables = _layer_params(jenc, 1, (x, xm))
    want = jenc.apply(variables, jnp.asarray(x), jnp.asarray(xm), train=False)
    enc = EncoderLayer(d, 4, 2 * d, gates=gates).eval()
    enc.load_state_dict(convert_tree(variables["params"], {}))
    with torch.no_grad():
        got = enc(_t(x), _t(xm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    jdec = jtransformer.TorchDecoderLayer(d, 4, 4 * d)
    variables = _layer_params(jdec, 2, (x, mem, xm, mm))
    want = jdec.apply(variables, *(jnp.asarray(a) for a in (x, mem, xm, mm)), train=False)
    dec = DecoderLayer(d, 4, 4 * d, gates=gates).eval()
    dec.load_state_dict(convert_tree(variables["params"], {}))
    with torch.no_grad():
        got = dec(_t(x), _t(mem), _t(xm), _t(mm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _gather_case(seed, n, p, q, c, dtype="float32"):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, p, c)).astype(np.float32)
    idx = rng.integers(0, p, size=(n, q)).astype(np.int32)
    idx[0, : q // 2] = 3                            # one point hit many times
    tdt, jdt = DTYPES[dtype]
    return values, idx, tdt, jdt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,p,q,c", [(3, 16, 40, 6), (2, 64, 256, 67), (2, 8, 100, 131)])
def test_gather_rows_plain_is_bit_equal_to_the_interpret_kernel(n, p, q, c, dtype):
    values, idx, tdt, jdt = _gather_case(n + p + q, n, p, q, c, dtype)
    want = np.asarray(gather_rows_pallas(jnp.asarray(values, jdt), jnp.asarray(idx),
                                         interpret=True).astype(jnp.float32))
    tv = torch.tensor(values).to(tdt)
    for got in (gather_rows_plain(tv, torch.tensor(idx)), gather_rows(tv, torch.tensor(idx))):
        assert got.dtype == tdt and got.shape == (n, q, c)
        assert got.float().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("q,tile_q", [(384, 128), (300, 128), (64, 2048)])
def test_gather_rows_grad_matches_jax(q, tile_q):
    """Forward and VJP against the JAX custom VJP (tiled over Q, its
    scatter a transposed one-hot per tile), with many duplicate indices."""
    values, idx, _, _ = _gather_case(q, 3, 16, q, 8)
    g = np.random.default_rng(1).normal(size=(3, q, 8)).astype(np.float32)
    jfn = functools.partial(jax_gather_rows_grad, tile_q=tile_q, interpret=True)
    want, vjp = jax.vjp(lambda v: jfn(v, jnp.asarray(idx)), jnp.asarray(values))
    (want_dv,) = vjp(jnp.asarray(g))
    tv = torch.tensor(values, requires_grad=True)
    out = gather_rows_grad(tv, torch.tensor(idx))
    out.backward(torch.tensor(g))
    assert out.detach().numpy().tobytes() == np.asarray(want).tobytes()
    want_dv = np.asarray(want_dv)
    for got in (tv.grad, scatter_rows_plain(torch.tensor(g), torch.tensor(idx), 16)):
        assert np.abs(got.numpy() - want_dv).max() <= 1e-6 * np.abs(want_dv).max()


def test_scatter_rows_plain_sums_in_f32_and_keeps_the_dtype():
    values, idx, _, _ = _gather_case(2, 2, 8, 50, 4)
    g = torch.tensor(values[:, :1].repeat(50, axis=1)).to(torch.bfloat16)
    got = scatter_rows_plain(g, torch.tensor(idx), 8)
    assert got.dtype == torch.bfloat16
    want = scatter_rows_plain(g.float(), torch.tensor(idx), 8).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("vmem_gather", [False, True])
def test_onehot_gather_matches_jax(vmem_gather):
    values, _, _, _ = _gather_case(4, 3, 16, 1, 5)
    idx = np.random.default_rng(5).integers(0, 16, size=(3, 6, 4)).astype(np.int32)
    want = np.asarray(jax_onehot_gather(jnp.asarray(values), jnp.asarray(idx)))
    got = onehot_gather(torch.tensor(values), torch.tensor(idx), vmem_gather=vmem_gather)
    assert got.shape == (3, 6, 4, 5)
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(gather_neighbors(torch.tensor(values), torch.tensor(idx),
                                        vmem_gather), got)


def _pointnet_pair(**kw):
    pcfg = Config().model.pointnet
    pcfg = dataclasses.replace(pcfg, num_points=32, sa_num_points=(16, 8, 4),
                               sa_mlps=((6, 8, 16), (19, 16, 32), (35, 32, 32)),
                               sa_max_neighbors=8, global_mlp=(35, 32, 64),
                               head_dims=(48, 32))
    nets = [PointNet2(pcfg, JC.NUM_CLASSES, JC.NUM_COLORS, sa_mode="off", vmem_gather=v,
                      **kw) for v in (False, True)]
    nets[1].load_state_dict(nets[0].state_dict())
    rng = np.random.default_rng(8)
    xyz = torch.tensor(rng.random((5, 32, 3)).astype(np.float32))
    rgb = torch.tensor(rng.random((5, 32, 3)).astype(np.float32))
    return nets, xyz, rgb


def test_pointnet2_off_with_vmem_gather_equals_without():
    nets, xyz, rgb = _pointnet_pair()
    with torch.no_grad():
        a, b = (net.eval()(xyz, rgb) for net in nets)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pointnet2_training_gather_with_vmem_gather_equals_without():
    """The plain training branch at every level: levels 2-3 gather features
    that carry a gradient, through gather_rows_grad (scatter-add backward)."""
    nets, xyz, rgb = _pointnet_pair(fused_train="0")
    obj = torch.tensor([True, True, True, True, False])
    outs = []
    for net in nets:
        feats = net.train()(xyz, rgb, obj)
        feats.features2.square().sum().backward()
        outs.append((feats.features2.detach(),
                     {k: p.grad.clone() for k, p in net.named_parameters()
                      if p.grad is not None}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys() and "sa1.dense_0.weight" in outs[0][1]
    for k, g in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][k].numpy(), g.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_fused_train_tokens():
    assert fused_train_list(None, 3) == ("0", "0", "1")
    assert fused_train_list("0,e,e", 3) == ("0", "e", "e")
    assert fused_train_list("e32", 3) == ("e32",) * 3
    assert fused_train_list((True, False, "e"), 3) == ("1", "0", "e")
    assert fused_train_list("", 2) == ("0", "0")
    with pytest.raises(ValueError):
        fused_train_list("0,e", 3)
    with pytest.raises(ValueError):
        fused_train_list("1,x,1", 3)


@pytest.mark.parametrize("body", ["float32", "bfloat16"])
def test_stage_auto_matches_jax(monkeypatch, body):
    """default_fused_train is the JAX stage auto below its HBM budget for
    cached edges (the port caches no edges and has no budget), else the
    module default."""
    monkeypatch.delenv("TEXT2LOC_FUSED_SA_ECACHE_GB", raising=False)
    jcfg, pcfg = JaxConfig(), Config()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, body_dtype=body))
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, body_dtype=body))
    assert psteps.COARSE_FUSED_TRAIN_AUTO == jsteps.COARSE_FUSED_TRAIN_AUTO
    assert psteps.FINE_FUSED_TRAIN_AUTO == jsteps.FINE_FUSED_TRAIN_AUTO
    for kind, auto in (("coarse", jsteps.COARSE_FUSED_TRAIN_AUTO),
                       ("fine", jsteps.FINE_FUSED_TRAIN_AUTO)):
        want = jsteps._stage_auto(jcfg, auto, 0) or ("0", "0", "1")
        assert psteps.default_fused_train(pcfg, kind) == tuple(want), kind


def test_default_fused_train_is_the_stage_auto_at_the_step():
    cfg = Config()
    assert psteps.default_fused_train(cfg, "coarse") == ("e32", "e32", "1")
    assert psteps.default_fused_train(cfg, "fine") == ("0", "e32", "e32")
    big = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=256))
    assert psteps.default_fused_train(big, "coarse") == ("e32", "e32", "1")
    bf16 = cfg.replace(model=dataclasses.replace(cfg.model, body_dtype="bfloat16"))
    assert psteps.default_fused_train(bf16, "coarse") == ("0", "0", "1")
    model = build_model(cfg.replace(model=dataclasses.replace(
        cfg.model, pointnet=dataclasses.replace(cfg.model.pointnet))), "fine",
        fused_train="0,e,e")
    assert [getattr(model.object_encoder.pointnet, f"sa{i}").fused_train
            for i in (1, 2, 3)] == ["0", "e", "e"]


# ----------------------------------------------------------- the pipeline

OPTIN = {"ln_all_ffn0": dict(fused_ln="all", fused_ffn="0"),
         "ln_all_attn0_vmem": dict(fused_ln="all", fused_attn="0", vmem_gather=True)}


@pytest.fixture(scope="module")
def wide(small_cfg, small_data):
    """The small test config with every transformer width 128 (the default
    test widths, 16-64, never open the LN gate), JAX towers with randomized
    BN statistics, and the JAX pipeline's result on the CPU (stock ops)."""
    from text2loc_tpu.training import steps

    m = dataclasses.replace(small_cfg.model, text_embed_dim=128, coarse_embed_dim=128,
                            fine_embed_dim=128)
    cfg = small_cfg.replace(model=m)
    jemb = JaxEmbedder.compositional(embed_dim=128, max_tokens=m.max_hint_tokens)
    rng = jax.random.PRNGKey(0)
    opt = steps.make_optimizer(cfg, 1)
    towers = {}
    cm = CellRetrievalNetwork(cfg.model)
    cobj, ctext = steps.prepare_coarse_batch(
        small_data.gather_coarse(np.arange(4), m.object_size), jemb, cfg, rng, train=False)
    towers["coarse"] = (steps.init_train_state(cm, opt, rng, cobj, ctext), cm)
    fm = CrossMatch(cfg.model)
    fb = steps.prepare_fine_batch(small_data.gather_fine(np.arange(4), m.pad_size), jemb,
                                  cfg, rng, train=False)
    towers["fine"] = (steps.init_train_state(fm, opt, rng, fb.objects, fb.text), fm)
    for i, (kind, (st, mod)) in enumerate(towers.items()):
        rs = np.random.default_rng(20 + i)

        def leaf(path, a, rs=rs):
            a = np.asarray(a)
            if str(path[-1].key).endswith("var"):
                return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return (a + 0.1 * rs.normal(size=a.shape)).astype(np.float32)

        towers[kind] = (st._replace(batch_stats=jax.tree_util.tree_map_with_path(
            leaf, st.batch_stats)), mod)
    (cs, cm), (fs, fm) = towers["coarse"], towers["fine"]
    want = jpipeline.run_pipeline(small_data, cs, cm, fs, fm, jemb, cfg, verbose=False)
    return cfg, towers, want


@pytest.mark.parametrize("opts", sorted(OPTIN))
def test_run_pipeline_with_opt_in_options_matches_jax(wide, small_data, opts):
    """run_pipeline with the LN gate open at every width (fused_ln="all"),
    a stock feed-forward or attention block before it, and the VMEM gather
    in SA mode off, against the JAX pipeline on the same weights."""
    cfg, towers, want = wide
    models = []
    for kind in ("coarse", "fine"):
        st, _ = towers[kind]
        model = build_model(cfg, kind, sa_mode="off", **OPTIN[opts])
        model.load_state_dict(from_jax_params(jax.device_get(st.params),
                                              jax.device_get(st.batch_stats), cfg, kind))
        models.append(model.eval())
    emb = HintTextEmbedder.compositional(128, cfg.model.max_hint_tokens)
    got = pipeline.run_pipeline(small_data, *models, emb, cfg, device="cpu", verbose=False)
    assert got["coarse"] == want["coarse"] and got["fine"] == want["fine"]
    np.testing.assert_array_equal(got["retrievals"], np.asarray(want["retrievals"]))
    np.testing.assert_allclose(got["pos_in_cells"], want["pos_in_cells"], atol=POS_ATOL,
                               rtol=0)


def test_rank_kernels_puts_kernels_slower_than_their_library_call_first(tmp_path):
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                        "rank_kernels.py")
    spec = importlib.util.spec_from_file_location("rank_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def k(name, ms, bound, launches, lib=None):
        return {"name": name, "ms": ms, "bound_ms": bound, "launches": launches,
                "library_ms": lib}

    out = tmp_path / "smoke.txt"
    out.write_text("noise\n" + json.dumps({"kernels": [
        k("fast_lib", 1.0, 0.1, 50, lib=2.0), k("big", 10.0, 1.0, 10),
        k("slow_lib", 3.0, 0.5, 1, lib=1.0), k("many", 2.0, 0.0, 60)]}) + "\n")
    rows = mod.rank(mod.kernels_line(str(out)))
    assert [r["name"] for r in rows] == ["slow_lib", "many", "big", "fast_lib"]
    assert rows[0]["slower_than_library"] and not rows[1]["slower_than_library"]
    assert rows[1]["launches_x_excess_ms"] == 120.0
