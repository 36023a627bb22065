"""The port's online T5 path (text2loc_tpu_torch/models/t5_encoder.py)
against the JAX package's text2loc_tpu/models/t5_encoder.py.

Weights: tiny HF `T5EncoderModel`s, randomly initialised from a torch seed,
converted by both packages' `convert_t5_encoder`; inputs seeded with numpy.
Snapshots are written by HF `save_pretrained` (safetensors and .bin) beside
the vendored tiny tokenizer. Tolerances: converted params and bucket ids
equal; f32 forwards and encodes within 1e-5 abs (both packages sum in other
orders); bf16 forwards within two bf16 ulps at the largest output magnitude
and a mean absolute difference of BF16_MEAN_ATOL (see test_encoder_matches_jax);
the compositional encoder bit for bit.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer
from transformers import T5Config as HFT5Config
from transformers import T5EncoderModel

from text2loc_tpu import constants as JC
from text2loc_tpu import text_styles as jstyles
from text2loc_tpu.assets import tiny_t5_tokenizer_path as jax_tokenizer_dir
from text2loc_tpu.models import t5_encoder as J
from text2loc_tpu.models.text_embedding import HintTextEmbedder as JaxEmbedder
from text2loc_tpu_torch.assets import load_tiny_tokenizer, tiny_t5_tokenizer_path
from text2loc_tpu_torch.models import t5_encoder as P
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.torch_checkpoint import to_numpy

F32_ATOL = 1e-5
# The bf16 forward's mean absolute difference from the JAX encoder's on
# test_encoder_matches_jax's inputs (outputs up to 3.7 in magnitude).
# Measured: relu 3.3e-4, gated-gelu 1.9e-3 (largest differences 2**-6 and
# 2**-5, one and two ulps). Variants that leave the JAX numerics measure
# 3.9e-3 (relu) and 4.8e-3 (gated-gelu) or more: the scores, or the softmax,
# in bf16. So does F.gelu for the gated feed-forward (3.8e-3): it rounds once
# where the JAX form rounds each op.
BF16_MEAN_ATOL = {"relu": 1e-3, "gated-gelu": 3e-3}
NOVEL = ["A zeppelin hovers nearby.", "Take me to the big glowing obelisk.",
         "ünïcödé ☃☃ snow", "", "The pose is north of a gray building."]


def tiny_hf_t5(ffn="relu", d_model=64, seed=0, max_distance=128):
    """A randomly initialised HF T5 encoder over the tiny tokenizer's 230
    pieces (vocab 256)."""
    torch.manual_seed(seed)
    return T5EncoderModel(HFT5Config(
        vocab_size=256, d_model=d_model, d_kv=16, num_heads=d_model // 16, d_ff=2 * d_model,
        num_layers=2, num_decoder_layers=0, feed_forward_proj=ffn,
        relative_attention_num_buckets=32, relative_attention_max_distance=max_distance,
        dropout_rate=0.0)).eval()


def write_t5_snapshot(path, d_model=64, safe=True, ffn="relu", max_distance=128) -> str:
    """An HF snapshot directory: save_pretrained of a tiny T5 encoder and the
    vendored tokenizer's files."""
    tiny_hf_t5(ffn, d_model, max_distance=max_distance).save_pretrained(
        path, safe_serialization=safe)
    for name in os.listdir(tiny_t5_tokenizer_path()):
        shutil.copy(os.path.join(tiny_t5_tokenizer_path(), name), path)
    return str(path)


def styled_sentences(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [jstyles.render_styled_hint(int(rng.integers(JC.NUM_DIRECTIONS)),
                                       int(rng.integers(JC.NUM_COLORS)),
                                       int(rng.integers(JC.NUM_CLASSES)), rng)
            for _ in range(n)]


@pytest.fixture(scope="module")
def hf_tokenizer():
    return AutoTokenizer.from_pretrained(jax_tokenizer_dir())


@pytest.mark.parametrize("length,buckets,distance",
                         [(1, 32, 128), (7, 8, 20), (16, 32, 128), (40, 32, 128),
                          (200, 16, 50)])
def test_relative_position_buckets_equal(length, buckets, distance):
    np.testing.assert_array_equal(P.relative_position_buckets(length, buckets, distance),
                                  J.relative_position_buckets(length, buckets, distance))


@pytest.mark.parametrize("ffn", ["relu", "gated-gelu"])
def test_convert_equals_jax(ffn):
    sd = to_numpy(tiny_hf_t5(ffn, max_distance=20).state_dict())
    got, got_cfg = P.convert_t5_encoder(sd, max_distance=20)
    want, want_cfg = J.convert_t5_encoder(sd, max_distance=20)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.feed_forward_proj == ffn and got_cfg.num_layers == 2
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ffn", ["relu", "gated-gelu"])
def test_encoder_matches_jax(ffn, dtype):
    params, cfg = J.convert_t5_encoder(to_numpy(tiny_hf_t5(ffn).state_dict()))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (5, 16)).astype(np.int32)
    mask = np.ones((5, 16), np.int32)
    mask[1, 9:] = 0
    mask[3, 3:] = 0
    want = np.asarray(J.T5Encoder(cfg).apply({"params": params}, jnp.asarray(ids),
                                             jnp.asarray(mask)).astype(jnp.float32))
    model = P.T5Encoder(P.T5Config(**dataclasses.asdict(cfg))).load_params(params)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        k: v.shape for k, v in params.items()}
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == getattr(torch, dtype)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
    assert np.abs(got - want).mean() <= BF16_MEAN_ATOL[ffn]


def test_load_params_checks_names_and_shapes():
    params, cfg = P.convert_t5_encoder(to_numpy(tiny_hf_t5().state_dict()))
    model = P.T5Encoder(cfg)
    with pytest.raises(KeyError, match="block_1_wo"):
        model.load_params({k: v for k, v in params.items() if k != "block_1_wo"})
    with pytest.raises(ValueError, match="rel_bias"):
        model.load_params({**params, "rel_bias": params["rel_bias"][:4]})


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_from_snapshot_equals_jax(form, tmp_path):
    path = write_t5_snapshot(tmp_path, safe=form == "safetensors", max_distance=20)
    assert os.path.exists(os.path.join(
        path, "model.safetensors" if form == "safetensors" else "pytorch_model.bin"))
    got_enc = P.T5OnlineEncoder.from_snapshot(path, max_tokens=16, device="cpu")
    want_enc = J.T5OnlineEncoder.from_snapshot(path, max_tokens=16)
    assert got_enc.cfg.relative_attention_max_distance == 20
    sentences = styled_sentences() + NOVEL
    got, got_mask = got_enc.encode(sentences)
    want, want_mask = want_enc.encode(sentences)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_read_safetensors_equals_the_library(dtype, tmp_path):
    from safetensors.torch import load_file, save_file

    tdt = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]
    gen = torch.Generator().manual_seed(0)
    tensors = {"shared.weight": torch.randn(7, 5, generator=gen).to(tdt),
               "encoder.block.0.x": torch.randn(3, generator=gen).to(tdt),
               "encoder.empty": torch.zeros(0, 4, dtype=tdt),
               "decoder.block.0.y": torch.randn(2, 2, generator=gen).to(tdt)}
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = P.read_safetensors(path)
    want = load_file(path)
    assert set(got) == {"shared.weight", "encoder.block.0.x", "encoder.empty"}
    for k, v in got.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want[k].float().numpy(), err_msg=k)


def test_from_snapshot_without_hf_libraries(tmp_path):
    """from_snapshot in a process where transformers, tokenizers and
    safetensors cannot be imported gives this process's encoding."""
    path = write_t5_snapshot(tmp_path / "snap")
    sentences = styled_sentences(6) + NOVEL
    out = tmp_path / "out.npz"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["transformers"] = sys.modules["tokenizers"] = None
        sys.modules["safetensors"] = sys.modules["sentencepiece"] = None
        import numpy as np
        from text2loc_tpu_torch.models.t5_encoder import T5OnlineEncoder
        enc = T5OnlineEncoder.from_snapshot({str(path)!r}, max_tokens=16, device="cpu")
        emb, mask = enc.encode({sentences!r})
        np.savez({str(out)!r}, emb=emb, mask=mask)
        assert not [m for m in ("jax", "text2loc_tpu") if m in sys.modules]
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)
    want, want_mask = P.T5OnlineEncoder.from_snapshot(path, max_tokens=16,
                                                      device="cpu").encode(sentences)
    with np.load(out) as f:
        np.testing.assert_array_equal(f["mask"], want_mask)
        np.testing.assert_allclose(f["emb"], want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def encoders(hf_tokenizer):
    params, cfg = J.convert_t5_encoder(to_numpy(tiny_hf_t5().state_dict()))
    return (P.T5OnlineEncoder(params, P.T5Config(**dataclasses.asdict(cfg)),
                              load_tiny_tokenizer(), max_tokens=12, device="cpu"),
            J.T5OnlineEncoder(params, cfg, hf_tokenizer, max_tokens=12))


@pytest.mark.parametrize("n", [0, 1, 3, 5])
def test_encode_equals_jax_row_by_row(encoders, n):
    """The JAX encoder pads a batch to a power of two; the port runs it at
    its size: the rows agree either way."""
    got_enc, want_enc = encoders
    sentences = (styled_sentences(4) + NOVEL)[:n]
    got, got_mask = got_enc.encode(sentences)
    want, want_mask = want_enc.encode(sentences)
    assert got.shape == (n, 12, 64) and got.dtype == np.float32
    assert got_mask.shape == (n, 12) and got_mask.dtype == bool
    np.testing.assert_array_equal(got_mask, want_mask)
    for i in range(n):
        np.testing.assert_allclose(got[i], want[i], atol=F32_ATOL, rtol=0)
    assert got_enc.embed_dim == want_enc.embed_dim == 64


def test_online_encoder_on_the_card_needs_one(encoders, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.T5OnlineEncoder({}, encoders[0].cfg, None)


def test_compositional_online_bit_equal_to_jax():
    sentences = [JC.render_hint(2, 3, 5), JC.render_hint(0, 1, 7)] + styled_sentences(6) + NOVEL
    got, got_mask = P.CompositionalOnlineEncoder(embed_dim=16, max_tokens=10).encode(sentences)
    want, want_mask = J.CompositionalOnlineEncoder(embed_dim=16, max_tokens=10).encode(sentences)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got, want)


def test_from_t5_table_equals_jax(hf_tokenizer, tmp_path):
    hf = tiny_hf_t5()
    want = JaxEmbedder.from_t5(max_tokens=12, model=hf, tokenizer=hf_tokenizer)
    params, cfg = P.convert_t5_encoder(to_numpy(hf.state_dict()))
    cache = str(tmp_path / "table.npz")
    got = HintTextEmbedder.from_t5(max_tokens=12, model=P.T5Encoder(cfg).load_params(params),
                                   tokenizer=load_tiny_tokenizer(), cache_path=cache)
    np.testing.assert_array_equal(got.token_mask.numpy(), np.asarray(want.token_mask))
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table), atol=F32_ATOL,
                               rtol=0)
    again = HintTextEmbedder.from_t5(cache_path=cache)     # read back, no encoder
    assert again.checksum() == got.checksum()
    snap = write_t5_snapshot(tmp_path / "snap")
    from_snap = HintTextEmbedder.from_t5(snap, max_tokens=12, device="cpu")
    np.testing.assert_allclose(from_snap.table.numpy(), got.table.numpy(), atol=F32_ATOL,
                               rtol=0)


def test_config_json_is_read(tmp_path):
    path = write_t5_snapshot(tmp_path, max_distance=40)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["relative_attention_max_distance"] == 40
    enc = P.T5OnlineEncoder.from_snapshot(path, device="cpu", dtype="bfloat16")
    assert enc.cfg.relative_attention_max_distance == 40 and enc.cfg.dtype == "bfloat16"
    emb, _ = enc.encode(["The pose is west of a beige pole."])
    assert emb.dtype == np.float32 and np.isfinite(emb).all()
