"""The attention block above d=256 (ops/mha.py's plain stages, ops/cuda_mha.py's
route) against the JAX package.

- mha_addln_plain against the Pallas kernel fused_mha_addlayernorm in
  interpret mode at the tiled route's widths (D=1024 self-attention with
  B*Lq not a multiple of 16, D=512 cross-attention), each with a sample
  whose keys are all masked: ATOL in f32; in bf16 one bf16 ulp of
  max|want| (the two sum the products in another order, which can round a
  bf16 intermediate the other way).
- Each plain stage (project, core, out + LayerNorm) in f32 against the
  same step written in jnp after mha_addlayernorm_ref, at 1e-5 x max|ref|.
- The route: the fused kernel for the smoke's d <= 256 shapes, the tiled
  chain above, and no attention shape of Config()'s models refused under
  fused_attn "1" or "all".
- The tiled chain's attention core: its plan (one sweep where a chunk of
  16, 32 or 64 keys holds every key, else two), and a plain emulation of
  its order of sums held to the one-block function (controls: online
  softmax, padded key slots biased like masked keys).

The kernels themselves run only on the card: tests/test_torch_port_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.ops.pallas_mha import fused_mha_addlayernorm
from text2loc_tpu_torch.config import Config
from text2loc_tpu_torch.convert import build_model
from text2loc_tpu_torch.models.transformer import MultiheadAttentionParams, fused_attn_enabled
from text2loc_tpu_torch.ops import cuda_mha
from text2loc_tpu_torch.ops.mha import (mha_addln, mha_addln_plain, mha_core_plain,
                                        mha_out_addln_plain, mha_project_plain)

ATOL = 1e-5
HEADS = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, lq, lk, d, self_attn):
    """numpy f32 x, kv, weights [in, out], biases, LN scale/bias, and a key
    mask with sample 1 all masked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, lq, d)).astype(np.float32)
    kv = x if self_attn else rng.normal(size=(b, lk, d)).astype(np.float32)
    mats = [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32) for _ in range(4)]
    vecs = [(0.1 * rng.normal(size=d)).astype(np.float32) for _ in range(4)]
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    mask = rng.random((b, lk)) > 0.3
    mask[:, 0] = True
    mask[1] = False
    return x, kv, mats, vecs, scale, bias, mask


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.mark.parametrize("dtype,b,lq,lk,d,self_attn", [
    (torch.float32, 3, 13, 13, 1024, True),
    (torch.bfloat16, 3, 13, 13, 1024, True),
    (torch.bfloat16, 3, 16, 6, 512, False),
])
def test_mha_plain_matches_pallas_kernel_above_d256(dtype, b, lq, lk, d, self_attn):
    x, kv, mats, vecs, scale, bias, mask = _inputs(7, b, lq, lk, d, self_attn)
    dh = d // HEADS
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    want = fused_mha_addlayernorm(
        jx, jx if self_attn else jnp.asarray(kv).astype(jdt),
        *(jnp.asarray(a) for a in (mats[0].reshape(d, HEADS, dh), vecs[0].reshape(HEADS, dh),
                                   mats[1].reshape(d, HEADS, dh), vecs[1].reshape(HEADS, dh),
                                   mats[2].reshape(d, HEADS, dh), vecs[2].reshape(HEADS, dh),
                                   mats[3].reshape(HEADS, dh, d), vecs[3], scale, bias)),
        key_mask=jnp.asarray(mask), num_heads=HEADS, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tx = _t(x).to(dtype)
    args = (tx, tx if self_attn else _t(kv).to(dtype), _t(mats[0]), _t(vecs[0]), _t(mats[1]),
            _t(vecs[1]), _t(mats[2]), _t(vecs[2]), _t(mats[3]), _t(vecs[3]), _t(scale),
            _t(bias), _t(mask))
    got = mha_addln_plain(*args, num_heads=HEADS)
    assert got.dtype == dtype and got.shape == (b, lq, d)
    atol = ATOL if dtype == torch.float32 else _bf16_ulp(float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    np.testing.assert_array_equal(mha_addln(*args, num_heads=HEADS).float().numpy(),
                                  got.float().numpy())


def _close_rel(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("b,lq,lk,d,self_attn", [(3, 13, 13, 1024, True),
                                                 (3, 16, 6, 512, False)])
def test_plain_stages_match_jnp_steps(b, lq, lk, d, self_attn):
    """Each stage on the same numpy inputs as the jnp step of
    mha_addlayernorm_ref (text2loc_tpu/ops/pallas_mha.py:205-231), f32."""
    x, kv, mats, vecs, scale, bias, mask = _inputs(8, b, lq, lk, d, self_attn)
    dh = d // HEADS
    hp = jax.lax.Precision.HIGHEST
    # (a) projections; the ref scales the scores by 1/sqrt(dh), the stage q.
    jq = (jnp.einsum("bld,dk->blk", x, mats[0], precision=hp) + vecs[0]) / np.sqrt(dh)
    jk = jnp.einsum("bld,dk->blk", kv, mats[1], precision=hp) + vecs[1]
    jv = jnp.einsum("bld,dk->blk", kv, mats[2], precision=hp) + vecs[2]
    q, k, v = mha_project_plain(_t(x), _t(kv), _t(mats[0]), _t(vecs[0]), _t(mats[1]),
                                _t(vecs[1]), _t(mats[2]), _t(vecs[2]), num_heads=HEADS)
    for got, ref in ((q, jq), (k, jk), (v, jv)):
        _close_rel(got, ref)
    # (b) the core on the same numpy q, k, v (a fully masked sample included).
    nq, nk, nv = (np.asarray(a) for a in (jq, jk, jv))
    s = jnp.einsum("bqhk,bmhk->bhqm", nq.reshape(b, lq, HEADS, dh),
                   nk.reshape(b, lk, HEADS, dh), precision=hp)
    s = jnp.where(jnp.asarray(mask)[:, None, None, :], s, -1e9)
    p = jax.nn.softmax(s, axis=-1)
    jo = jnp.einsum("bhqm,bmhk->bqhk", p, nv.reshape(b, lk, HEADS, dh),
                    precision=hp).reshape(b, lq, d)
    o = mha_core_plain(_t(nq), _t(nk), _t(nv), _t(mask), num_heads=HEADS)
    _close_rel(o, jo)
    # (c) + (d) the out-projection, residual and LayerNorm on the same o.
    no = np.asarray(jo)
    s2 = x + jnp.einsum("bqk,kd->bqd", no, mats[3], precision=hp) + vecs[3]
    mu = jnp.mean(s2, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(s2 - mu), axis=-1, keepdims=True)
    jy = (s2 - mu) * jax.lax.rsqrt(var + 1e-5) * scale + bias
    y = mha_out_addln_plain(_t(x), _t(no), _t(mats[3]), _t(vecs[3]), _t(scale), _t(bias))
    _close_rel(y, jy)


# The SMs of an H100 SXM, the card the plans below are written for.
SMS = 132
# (Lq, Lk, D, self-attention) of chip_smoke.py's fused cases.
SMOKE_FUSED = [(16, 6, 128, False), (6, 16, 128, False), (16, 16, 128, True),
               (6, 6, 128, True), (28, 28, 256, True), (6, 6, 256, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_the_fused_kernel_to_d256_and_the_tiled_chain_above(dtype):
    for lq, lk, d, self_attn in SMOKE_FUSED:
        assert cuda_mha.route(lq, lk, d, HEADS, dtype, self_attn=self_attn) == "fused"
    assert cuda_mha.route(16, 16, 1024, HEADS, dtype, self_attn=True) == "tiled"
    assert cuda_mha.route(16, 6, 512, HEADS, dtype) == "tiled"
    # d <= 256 whose fused layout exceeds a block's shared memory.
    assert cuda_mha.route(64, 64, 256, HEADS, dtype, self_attn=True) == "tiled"
    cuda_mha.check_tiled(64, 64, 256, HEADS, dtype)


def test_fused_smem_is_make_layouts_sum():
    """fused_plan's shared bytes are layout() of csrc/mha_addln.cu, summed
    by hand (rows padded by 16 bytes; the ring of 3 weight chunks of 16 x
    (3 * 64 + 4) f32). B = 1: a cluster of 4 blocks, one per head, each
    with 16 rows of x and of every head's o [D + pad], its head's q, k, v
    [dh + pad], the f32 pre-norm rows [dh + 4] (over k, v where smaller)
    and two f32 row statistics. B = 1320: one block a group of 5 samples
    (Lq = 6, Lk = 16: 32 query and 80 key rows), q (over the kv rows), k, v
    over all D columns."""
    ring = 3 * 16 * 196 * 4
    p = cuda_mha.fused_plan(1, 16, 16, 128, 4, torch.bfloat16, self_attn=True, sms=SMS)
    assert (p.samples, p.rows, p.key_rows, p.blocks, p.cluster) == (1, 16, 16, 1, 4)
    assert p.smem == (2 * (2 * 16 * 136) + 2 * 16 * 40 + max(2 * (2 * 16 * 40), 4 * 16 * 36)
                      + 8 * 16 + ring)
    p = cuda_mha.fused_plan(1, 5, 3, 128, 4, torch.float32, sms=SMS)
    assert p.smem == (2 * (4 * 16 * 132) + 4 * 16 * 36 + max(2 * (4 * 16 * 36), 4 * 16 * 36)
                      + 8 * 16 + ring)
    p = cuda_mha.fused_plan(1320, 6, 16, 128, 4, torch.bfloat16, sms=SMS)
    assert (p.samples, p.rows, p.key_rows, p.blocks, p.cluster) == (5, 32, 80, 264, 1)
    assert p.smem == (2 * 32 * 136 + 2 * 80 * 136 + max(2 * (2 * 80 * 136), 4 * 32 * 132)
                      + 8 * 32 + ring)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plan_fits_and_covers_the_batch(dtype):
    """Every d <= 256 attention shape of Config()'s models (the JAX gate
    sends each to the fused Pallas kernel) at every pair of the config's
    sequence lengths gets a fused plan within a block's shared memory whose
    blocks cover B exactly, at the serve's and the smoke's batch sizes; at
    B = 640 a group packs min(80 // max(Lq, Lk), 5) samples (one wave of
    blocks), at B <= 132 one; a cluster of one block per head where those
    blocks fit the SMs."""
    from text2loc_tpu_torch.ops import _cuda

    cfg = Config()
    m = cfg.model
    lengths = sorted({m.max_hint_tokens, m.num_mentioned, m.object_size, m.pad_size})
    with torch.device("meta"):
        blocks = {(mod.query.weight.shape[0], mod.num_heads)
                  for kind in ("coarse", "fine") for mod in build_model(cfg, kind).modules()
                  if isinstance(mod, MultiheadAttentionParams)}
    small = {(d, h) for d, h in blocks if d <= cuda_mha.FUSED_MAX_D}
    assert {d for d, _ in small} == {128, 256}
    for d, heads in small:
        for lq in lengths:
            for lk in lengths:
                for self_attn in ((True, False) if lq == lk else (False,)):
                    assert cuda_mha.route(lq, lk, d, heads, dtype, self_attn=self_attn) == "fused"
                    for b in (0, 1, 5, 10, 33, 37, 64, 131, 132, 264, 640, 1000):
                        p = cuda_mha.fused_plan(b, lq, lk, d, heads, dtype,
                                                self_attn=self_attn, sms=SMS)
                        assert p is not None and 0 < p.smem <= _cuda.SMEM_LIMIT
                        assert p.blocks * p.samples >= b > (p.blocks - 1) * p.samples or (
                            b == 0 and p.blocks == 0)
                        assert p.rows == -(-p.samples * lq // 16) * 16 <= 80
                        assert p.key_rows == (p.rows if self_attn
                                              else -(-p.samples * lk // 16) * 16) <= 80
                        want_g = max(1, min(80 // max(lq, lk), -(-b // SMS)))
                        assert p.samples <= want_g
                        assert p.cluster == (heads if p.blocks * heads <= SMS else 1)
                        if b <= 132:
                            assert p.samples == 1
                    if dtype == torch.bfloat16:
                        assert cuda_mha.fused_plan(640, lq, lk, d, heads, dtype,
                                                   self_attn=self_attn, sms=SMS).samples == min(
                            80 // max(lq, lk), 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_fused_route_has_a_plan_at_every_batch(dtype):
    """Wherever route says "fused", fused_plan gives a plan within a block's
    shared memory at every B and on cards of 132 or 114 SMs, and None
    wherever it says "tiled": the launch plans at the call's B, the route
    at none. f32 cross-attention at D=256 with Lq=64, Lk=32 fits a cluster
    of one block per head at B=1 but not one block at B=640, so it takes
    the tiled chain at every B."""
    from text2loc_tpu_torch.ops import _cuda

    fused = 0
    for d, heads in ((64, 1), (128, 4), (128, 8), (256, 4), (256, 8), (256, 16)):
        for lq in (1, 5, 6, 16, 28, 32, 33, 48, 49, 64, 80, 81):
            for lk in (1, 6, 16, 28, 32, 33, 48):
                for self_attn in ((True, False) if lq == lk else (False,)):
                    routed = cuda_mha.route(lq, lk, d, heads, dtype, self_attn=self_attn)
                    fused += routed == "fused"
                    for sms in (132, 114):
                        for b in (0, 1, 33, 34, 64, 114, 132, 133, 640, 5000):
                            p = cuda_mha.fused_plan(b, lq, lk, d, heads, dtype,
                                                    self_attn=self_attn, sms=sms)
                            assert (p is not None) == (routed == "fused")
                            if p is not None:
                                assert 0 < p.smem <= _cuda.SMEM_LIMIT
                                assert p.samples * p.blocks >= b
                                assert p.cluster in (1, heads)
                                assert p.blocks * p.cluster <= sms or p.cluster == 1
    assert fused > 100
    assert cuda_mha.route(64, 32, 256, 4, torch.float32) == "tiled"
    assert cuda_mha.route(64, 32, 256, 4, torch.bfloat16) == "fused"
    cuda_mha.check_tiled(64, 32, 256, 4, torch.float32)


def test_check_tiled_names_its_limit():
    """The tiled chain refuses D off the multiples of 128 and a head too wide
    for the attention core's smallest key chunk (dh = 2048 in f32), naming
    the shared-memory limit; no length is refused. dh = 1280 in f32, past
    the largest chunk, takes the smallest in two sweeps."""
    with pytest.raises(ValueError, match="232448"):
        cuda_mha.check_tiled(512, 512, 2048, 1, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_mha.check_tiled(16, 16, 320, 4, torch.bfloat16)
    cuda_mha.check_tiled(512, 512, 1024, 4, torch.float32)
    wide = cuda_mha.check_tiled(512, 512, 1280, 1, torch.float32)
    assert (wide.chunk, wide.sweeps) == (16, 2) and wide.smem <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [117, 128, 512])
def test_check_tiled_takes_every_length(dtype, length):
    """At E=1024 with 4 heads every length gets a plan: past a chunk's 64
    keys the core sweeps the keys twice in chunks of 64, with shared memory
    that does not grow with Lq or Lk, self- and cross-attention alike."""
    layout = cuda_mha.check_tiled(length, length, 1024, 4, dtype)
    cuda_mha.check_tiled(16, length, 1024, 4, dtype)
    assert layout == cuda_mha.core_layout(length, length, 1024, 4, dtype)
    assert (layout.rows, layout.chunk, layout.sweeps) == (16, 64, 2)
    assert 0 < layout.smem <= 232448
    assert layout == cuda_mha.core_layout(4 * length, 3 * length, 1024, 4, dtype)
    assert layout.smem == cuda_mha.core_smem(64, 2, 256, dtype)


def test_config_shapes_keep_the_one_block_core():
    """Every attention shape of Config()'s models that takes the tiled chain
    (at every pair of the config's sequence lengths, both dtypes, fused_attn
    "all") gets the one-sweep core, whose chunk holds every key, the one the
    smoke measures; two sweeps start past 64 keys, at E=1024 in both
    dtypes."""
    cfg = Config()
    m = cfg.model
    lengths = sorted({m.max_hint_tokens, m.num_mentioned, m.object_size, m.pad_size})
    with torch.device("meta"):
        blocks = {(mod.query.weight.shape[0], mod.num_heads)
                  for kind in ("coarse", "fine") for mod in build_model(cfg, kind).modules()
                  if isinstance(mod, MultiheadAttentionParams)}
    seen = 0
    for d, heads in blocks:
        for dtype in (torch.float32, torch.bfloat16):
            for lq in lengths:
                for lk in lengths:
                    for self_attn in ((True, False) if lq == lk else (False,)):
                        if cuda_mha.route(lq, lk, d, heads, dtype, self_attn=self_attn) == "tiled":
                            plan = cuda_mha.core_layout(lq, lk, d, heads, dtype)
                            assert plan.sweeps == 1 and plan.chunk >= lk
                            seen += 1
    assert seen > 0
    for dtype in (torch.bfloat16, torch.float32):
        assert cuda_mha.core_layout(64, 64, 1024, 4, dtype).sweeps == 1
        assert cuda_mha.core_layout(65, 65, 1024, 4, dtype).sweeps == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_core_plan_sweeps_and_chunks(dtype, dh):
    """The core's plan at every length from 1 to 200 keys: the smallest of
    the chunks 16, 32, 64 that holds every key, in one sweep, with two
    buffers where they fit a block (the block pipelines its items); past 64
    keys, chunks of 64 in two sweeps with one buffer. Shared memory as
    core_smem sums it, within a block's."""
    buf = {c: cuda_mha._core_buffer(c, dh, dtype) for c in cuda_mha.CORE_CHUNKS}
    for lk in range(1, 201):
        plan = cuda_mha.core_layout(16, lk, 4 * dh, 4, dtype)
        if lk <= 64:
            want = min(c for c in cuda_mha.CORE_CHUNKS if c >= lk)
            smem = 2 * buf[want] if 2 * buf[want] <= 232448 else buf[want]
            assert (plan.rows, plan.chunk, plan.sweeps, plan.smem) == (16, want, 1, smem)
        else:
            assert (plan.rows, plan.chunk, plan.sweeps, plan.smem) == (16, 64, 2, buf[64])
        assert plan.smem == cuda_mha.core_smem(plan.chunk, plan.sweeps, dh, dtype) <= 232448
    assert cuda_mha.core_smem(16, 1, dh, dtype) == 2 * buf[16]


def _one_block_core(s, v, dt):
    """The one-block core's function on f32 scores s [Lq, Lk] (key bias
    added) and v [Lk, dh]: the row max; the sum of exp(s - max) in key
    order; p = round_T(exp(s - max) / sum); o sums p v in key order."""
    m = s.amax(dim=1)
    e = torch.exp(s - m[:, None])
    total = torch.zeros_like(m)
    for j in range(s.shape[1]):
        total = total + e[:, j]
    p = (e / total[:, None]).to(dt).float()
    o = torch.zeros(s.shape[0], v.shape[1])
    for j in range(s.shape[1]):
        o = o + p[:, j:j + 1] * v[j]
    return p, o


def _quad_sums(e):
    """A chunk's rows of exp(s - max) [rows, chunk] summed as the kernel sums
    them: lane t of a quad holds keys 8 j + 2 t and 8 j + 2 t + 1 and adds
    each pair in j order; the quad's butterfly adds lanes 0 + 1 and 2 + 3,
    then the two."""
    parts = []
    for t in range(4):
        acc = torch.zeros(e.shape[0])
        for j in range(e.shape[1] // 8):
            acc = acc + (e[:, 8 * j + 2 * t] + e[:, 8 * j + 2 * t + 1])
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _tiled_core(q, k, v, bias, dt, chunk, *, pads_as_keys=False, round_unnormalised=False):
    """The attention core's arithmetic (csrc/mha_tiled.cu) for one head:
    keys in chunks of `chunk`, the slots past Lk in the last chunk -inf.
    One sweep where a chunk holds every key: the chunk's max and sum, then
    p = round_T(exp(s - max) / sum) and o = p v. Two sweeps beyond: the
    rows' running max and rescaled sum over the chunks, then p and p v chunk
    by chunk. Returns (p [Lq, Lk], o [Lq, dh]). Controls: `pads_as_keys`
    biases the padded slots -1e9 (as masked keys); `round_unnormalised` is
    online softmax, which rounds exp(s - running max) before normalising."""
    lq, lk = q.shape[0], k.shape[0]
    n = -(-lk // chunk) * chunk
    s_all = torch.full((lq, n), -1e9 if pads_as_keys else -math.inf)
    s_all[:, :lk] = q @ k.t() + bias
    vp = torch.zeros(n, v.shape[1])
    vp[:lk] = v
    m = torch.full((lq,), -math.inf)
    total = torch.zeros(lq)
    acc = torch.zeros(lq, v.shape[1])
    sweeps = 1 if lk <= chunk else 2
    p_all = torch.zeros(lq, n)
    if sweeps == 2 or round_unnormalised:
        seen = []
        for c0 in range(0, n, chunk):
            s = s_all[:, c0:c0 + chunk]
            mn = torch.maximum(m, s.amax(dim=1))
            if round_unnormalised:
                p = torch.exp(s - mn[:, None]).to(dt).float()
                acc = acc * torch.exp(m - mn)[:, None] + p @ vp[c0:c0 + chunk]
                p_all[:, c0:c0 + chunk] = p
                seen.append(mn)
            total = total * torch.exp(m - mn) + _quad_sums(torch.exp(s - mn[:, None]))
            m = mn
        if round_unnormalised:   # the weight each key's v gets in the end
            for i, mc in enumerate(seen):
                p_all[:, i * chunk:(i + 1) * chunk] *= (torch.exp(mc - m) / total)[:, None]
            return p_all[:, :lk], acc / total[:, None]
    for c0 in range(0, n, chunk):
        s = s_all[:, c0:c0 + chunk]
        if sweeps == 1:
            m = s.amax(dim=1)
            total = _quad_sums(torch.exp(s - m[:, None]))
        p = (torch.exp(s - m[:, None]) / total[:, None]).to(dt).float()
        p_all[:, c0:c0 + chunk] = p
        acc = acc + p @ vp[c0:c0 + chunk]
    return p_all[:, :lk], acc


def _bf16_ulps(p):
    """The bf16 spacing at each value of p (0 < p <= 1; 2^-133 at 0)."""
    return torch.exp2(torch.floor(torch.log2(p.clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,dh", [(70, 100, 64), (16, 117, 256), (33, 13, 32)])
def test_key_tiled_softmax_matches_the_one_block_core(dt, lq, lk, dh):
    """The core's sweeps (one where the plan's chunk holds every key, else
    two: the running max and rescaled sum, then normalised p) against the
    one-block core's function, for a sample with masked keys (16 of them
    where Lk > 32) and an all-masked sample (uniform over its own keys): in f32 p
    within 1e-6 and o within 1e-6 x max|o|, and within 1e-5 of the plain
    core; in bf16 every p the same rounded value or one bf16 spacing off
    (the f32 sum's order of terms moves a quotient lying at a rounding
    boundary), in at most 1e-3 of the entries, o within 4e-4 x max|o|.
    Online softmax, which rounds the unnormalised p and scales it after,
    gives each key another weight than that rounded p in most entries, on
    every sample."""
    rng = np.random.default_rng(11)
    chunk = cuda_mha.core_layout(lq, lk, 4 * dh, 4, dt).chunk
    q, k, v = (torch.from_numpy((rng.normal(size=(2, n, dh)) * scale).astype(np.float32))
               .to(dt).float() for n, scale in ((lq, dh ** -0.5), (lk, 1.0), (lk, 1.0)))
    mask = torch.from_numpy(rng.random((2, lk)) > 0.3)
    mask[0, :1] = True
    if lk > 32:
        mask[0, 16:32] = False                        # a chunk of masked keys
    else:
        mask[0, 3:6] = False
    mask[1] = False                                   # an all-masked sample
    bias = torch.where(mask, 0.0, -1e9).float()
    plain = mha_core_plain(q.to(dt), k.to(dt), v.to(dt), mask, num_heads=1).float()
    for b in range(2):
        p_one, o_one = _one_block_core(q[b] @ k[b].t() + bias[b], v[b], dt)
        p_key, o_key = _tiled_core(q[b], k[b], v[b], bias[b], dt, chunk)
        top = o_one.abs().max()
        if dt == torch.float32:
            assert (p_key - p_one).abs().max() <= 1e-6
            assert (o_key - o_one).abs().max() <= 1e-6 * top
            assert (o_key - plain[b]).abs().max() <= 1e-5 * plain[b].abs().max()
        else:
            off = p_key != p_one
            assert off.float().mean() <= 1e-3
            assert ((p_key - p_one).abs() <= _bf16_ulps(torch.maximum(p_key, p_one))).all()
            assert (o_key - o_one).abs().max() <= 4e-4 * top
            p_online, _ = _tiled_core(q[b], k[b], v[b], bias[b], dt, chunk,
                                      round_unnormalised=True)
            assert (p_online != p_one).float().mean() > 0.5
        if b == 0:
            assert (p_key[:, ~mask[0]] == 0).all()
        else:
            assert torch.allclose(p_key, torch.full_like(p_key, 1.0 / lk), rtol=1e-2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lk", [13, 117])
def test_padded_key_slots_are_not_keys(dt, lk):
    """An all-masked sample attends uniformly over its own Lk keys: with 13
    keys in a chunk of 16 (one sweep), and 117 in chunks of 64 (two sweeps),
    the padded slots of the last chunk are excluded, so p = 1/Lk rounded;
    biased -1e9 like masked keys, they would take a share (1/16, 1/128)."""
    rng = np.random.default_rng(5)
    dh = 64
    chunk = cuda_mha.core_layout(16, lk, 4 * dh, 4, dt).chunk
    q, k, v = (torch.from_numpy(rng.normal(size=(n, dh)).astype(np.float32)).to(dt).float()
               for n in (16, lk, lk))
    q = q * dh ** -0.5
    bias = torch.full((lk,), -1e9)
    p, o = _tiled_core(q, k, v, bias, dt, chunk)
    want = torch.tensor(1.0 / lk).to(dt).float()
    assert torch.allclose(p, want.expand_as(p), rtol=1e-2, atol=0)
    p_one, o_one = _one_block_core(q @ k.t() + bias, v, dt)
    assert (o - o_one).abs().max() <= 4e-4 * o_one.abs().max()
    p_pad, _ = _tiled_core(q, k, v, bias, dt, chunk, pads_as_keys=True)
    slots = -(-lk // chunk) * chunk
    assert torch.allclose(p_pad, torch.full_like(p_pad, 1.0 / slots), rtol=1e-2)
    assert not torch.allclose(p_pad, p, rtol=1e-2)


@pytest.mark.parametrize("value", ["1", "all"])
def test_no_attention_shape_of_the_default_config_is_refused(value):
    """Every attention block of Config()'s two models (built on the meta
    device) at every pair of the config's sequence lengths (tokens, hints,
    objects, padded objects), in both dtypes: where the gate opens, the
    routed kernel takes the shape."""
    cfg = Config()
    m = cfg.model
    lengths = sorted({m.max_hint_tokens, m.num_mentioned, m.object_size, m.pad_size})
    blocks = set()
    with torch.device("meta"):
        for kind in ("coarse", "fine"):
            for mod in build_model(cfg, kind).modules():
                if isinstance(mod, MultiheadAttentionParams):
                    blocks.add((mod.query.weight.shape[0], mod.num_heads))
    assert (1024, cfg.model.intra_num_heads) in blocks
    tiled = set()
    for d, heads in blocks:
        for dtype in (torch.float32, torch.bfloat16):
            if not fused_attn_enabled(d, dtype, value):
                continue
            for lq in lengths:
                for lk in lengths:
                    for self_attn in ((True, False) if lq == lk else (False,)):
                        if cuda_mha.route(lq, lk, d, heads, dtype,
                                          self_attn=self_attn) == "tiled":
                            cuda_mha.check_tiled(lq, lk, d, heads, dtype)
                            tiled.add((d, dtype))
    assert (1024, torch.bfloat16) in tiled
    assert ((1024, torch.float32) in tiled) == (value == "all")
