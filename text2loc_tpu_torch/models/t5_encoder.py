"""The frozen T5 encoder, the online text path for sentences outside the
closed hint vocabulary (port of text2loc_tpu/models/t5_encoder.py: T5Config,
relative_position_buckets, rms_norm, T5Encoder, convert_t5_encoder,
T5OnlineEncoder, CompositionalOnlineEncoder).

The reference runs a frozen HF `T5EncoderModel` on every batch; the serve
takes the closed template vocabulary from the precomputed [V, T, E] table
(models/text_embedding.py) and sends any other sentence through
`T5OnlineEncoder`, whose embeddings `serving.Localizer.localize_text` feeds
to `localize_embedded`. The encoder runs the JAX package's numerics in plain
PyTorch (matrix products, a softmax and RMSNorm; the JAX encoder reaches no
Pallas kernel): RMSNorm pre-norm blocks, unscaled dot-product attention with
one bucketed relative-position bias shared by every layer, scores and
softmax in f32, ReLU or gated GELU (tanh) feed-forward, f32 parameters cast
to `cfg.dtype` where they are used.

`T5OnlineEncoder.from_snapshot` reads a local HF snapshot with no
`transformers`, `tokenizers` or `safetensors`: config.json,
model.safetensors (read by its header) or pytorch_model.bin
(`torch.load(weights_only=True)`), and tokenizer.json (tokenizer.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Shapes of the encoder stack (HF T5Config field names kept)."""

    vocab_size: int
    d_model: int
    d_kv: int
    num_heads: int
    d_ff: int
    num_layers: int
    feed_forward_proj: str = "relu"       # "relu" | "gated-gelu"
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: str = "float32"                # compute dtype (params stay f32)


def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """[L, L] int32 bucket ids for (query, key) pairs: T5's bidirectional
    log-bucketing (HF `T5Attention._relative_position_bucket`)."""
    ctx = np.arange(length, dtype=np.int64)
    rel = ctx[None, :] - ctx[:, None]                 # memory - query
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm: no mean subtraction, variance in f32, scale only."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return scale.to(x.dtype) * y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation, written as flax's `nn.gelu(approximate=True)`
    is: one op at a time in x's dtype, with sqrt(2/pi) in that dtype. In bf16
    each op rounds, as XLA's do; F.gelu rounds only its result, and differs
    from the JAX encoder in 43% of bf16 elements where this form differs in
    under 1%."""
    c = torch.tensor(np.sqrt(2.0 / np.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


def _param_shapes(c: T5Config) -> Dict[str, Tuple[int, ...]]:
    inner = c.num_heads * c.d_kv
    shapes = {"token_embed": (c.vocab_size, c.d_model),
              "rel_bias": (c.relative_attention_num_buckets, c.num_heads)}
    gated = c.feed_forward_proj.startswith("gated")
    for i in range(c.num_layers):
        shapes[f"block_{i}_ln0"] = (c.d_model,)
        for w in "qkv":
            shapes[f"block_{i}_{w}"] = (c.d_model, inner)
        shapes[f"block_{i}_o"] = (inner, c.d_model)
        shapes[f"block_{i}_ln1"] = (c.d_model,)
        for w in (("wi0", "wi1") if gated else ("wi",)):
            shapes[f"block_{i}_{w}"] = (c.d_model, c.d_ff)
        shapes[f"block_{i}_wo"] = (c.d_ff, c.d_model)
    shapes["final_ln"] = (c.d_model,)
    return shapes


class T5Encoder(nn.Module):
    """Frozen T5 encoder: (input_ids [B, L], attention_mask [B, L]) ->
    last_hidden_state [B, L, d_model] in `cfg.dtype`.

    Parameters carry the JAX package's flat names and shapes (token_embed,
    rel_bias, final_ln, block_{i}_{q,k,v,o,ln0,ln1,wi | wi0,wi1,wo}; matrices
    [in, out]), f32 and frozen; `load_params` fills them from the flat numpy
    params of `convert_t5_encoder` or of the JAX encoder."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        for name, shape in _param_shapes(cfg).items():
            init = torch.ones if name.endswith(("ln0", "ln1", "final_ln")) else torch.zeros
            self.register_parameter(name, nn.Parameter(
                init(shape, dtype=torch.float32, device=device), requires_grad=False))

    def load_params(self, params: Mapping[str, np.ndarray]) -> "T5Encoder":
        """Copy flat params (name -> array of the parameter's shape) in."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise KeyError(f"params differ from the encoder's: missing "
                           f"{sorted(set(own) - set(params))[:4]}, unexpected "
                           f"{sorted(set(params) - set(own))[:4]}")
        with torch.no_grad():
            for name, p in own.items():
                a = torch.as_tensor(np.asarray(params[name], np.float32))
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(a.shape)} != {tuple(p.shape)}")
                p.copy_(a)
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = getattr(torch, c.dtype)
        p = dict(self.named_parameters())
        x = F.embedding(input_ids.long(), self.token_embed).to(dt)

        # The relative-position bias (block 0's in HF, shared by every layer)
        # plus the additive key mask, in f32.
        b, length = input_ids.shape
        buckets = torch.as_tensor(relative_position_buckets(
            length, c.relative_attention_num_buckets, c.relative_attention_max_distance),
            dtype=torch.long, device=x.device)
        pos_bias = self.rel_bias.float()[buckets].permute(2, 0, 1)[None]   # [1, H, L, L]
        key_mask = torch.where(attention_mask.bool()[:, None, None, :], 0.0, -1e9)
        bias = pos_bias + key_mask.float()                                 # [B, H, L, L]

        inner = c.num_heads * c.d_kv
        gated = c.feed_forward_proj.startswith("gated")

        def heads(t):
            return t.reshape(b, length, c.num_heads, c.d_kv)

        for i in range(c.num_layers):
            # Self-attention, pre-norm; T5 omits the 1/sqrt(d_kv) scale.
            h = rms_norm(x, p[f"block_{i}_ln0"], c.layer_norm_epsilon)
            q = heads(h @ p[f"block_{i}_q"].to(dt))
            k = heads(h @ p[f"block_{i}_k"].to(dt))
            v = heads(h @ p[f"block_{i}_v"].to(dt))
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
            attn = torch.softmax(scores, dim=-1).to(dt)
            o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, length, inner)
            x = x + o @ p[f"block_{i}_o"].to(dt)

            # Feed-forward, pre-norm.
            h = rms_norm(x, p[f"block_{i}_ln1"], c.layer_norm_epsilon)
            if gated:
                h = (gelu_tanh(h @ p[f"block_{i}_wi0"].to(dt))
                     * (h @ p[f"block_{i}_wi1"].to(dt)))
            else:
                h = torch.relu(h @ p[f"block_{i}_wi"].to(dt))
            x = x + h @ p[f"block_{i}_wo"].to(dt)
        return rms_norm(x, self.final_ln, c.layer_norm_epsilon)


# ---------------------------------------------------------------------------
# HF state dict -> flat params
# ---------------------------------------------------------------------------


def convert_t5_encoder(sd: Mapping[str, np.ndarray],
                       max_distance: int = 128) -> Tuple[Dict, T5Config]:
    """HF `T5EncoderModel` state_dict (as numpy) -> (params, T5Config) for
    `T5Encoder`. Shapes, bucket count, and the feed-forward variant are
    inferred from the weights; `max_distance` is not recoverable from them
    (pass the HF config value when it differs from the T5 default 128)."""
    def t(a):
        return np.ascontiguousarray(np.asarray(a, np.float32).T)

    emb = sd.get("shared.weight", sd.get("encoder.embed_tokens.weight"))
    if emb is None:
        raise KeyError("no token embedding (shared.weight) in state dict")
    rel = sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    q0 = sd["encoder.block.0.layer.0.SelfAttention.q.weight"]    # [inner, D]
    num_heads = rel.shape[1]
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    wi_key = "wi_0" if gated else "wi"
    d_ff = sd[f"encoder.block.0.layer.1.DenseReluDense.{wi_key}.weight"].shape[0]

    num_layers = 0
    while f"encoder.block.{num_layers}.layer.0.SelfAttention.q.weight" in sd:
        num_layers += 1

    cfg = T5Config(
        vocab_size=emb.shape[0],
        d_model=q0.shape[1],
        d_kv=q0.shape[0] // num_heads,
        num_heads=num_heads,
        d_ff=d_ff,
        num_layers=num_layers,
        feed_forward_proj="gated-gelu" if gated else "relu",
        relative_attention_num_buckets=rel.shape[0],
        relative_attention_max_distance=max_distance,
    )

    params: Dict[str, np.ndarray] = {
        "token_embed": np.asarray(emb, np.float32),
        "rel_bias": np.asarray(rel, np.float32),
        "final_ln": np.asarray(sd["encoder.final_layer_norm.weight"], np.float32),
    }
    for i in range(num_layers):
        a = f"encoder.block.{i}.layer.0"
        f = f"encoder.block.{i}.layer.1"
        params[f"block_{i}_q"] = t(sd[f"{a}.SelfAttention.q.weight"])
        params[f"block_{i}_k"] = t(sd[f"{a}.SelfAttention.k.weight"])
        params[f"block_{i}_v"] = t(sd[f"{a}.SelfAttention.v.weight"])
        params[f"block_{i}_o"] = t(sd[f"{a}.SelfAttention.o.weight"])
        params[f"block_{i}_ln0"] = np.asarray(sd[f"{a}.layer_norm.weight"], np.float32)
        if gated:
            params[f"block_{i}_wi0"] = t(sd[f"{f}.DenseReluDense.wi_0.weight"])
            params[f"block_{i}_wi1"] = t(sd[f"{f}.DenseReluDense.wi_1.weight"])
        else:
            params[f"block_{i}_wi"] = t(sd[f"{f}.DenseReluDense.wi.weight"])
        params[f"block_{i}_wo"] = t(sd[f"{f}.DenseReluDense.wo.weight"])
        params[f"block_{i}_ln1"] = np.asarray(sd[f"{f}.layer_norm.weight"], np.float32)
    return params, cfg


# ---------------------------------------------------------------------------
# Snapshot readers
# ---------------------------------------------------------------------------

_ENCODER_KEYS = ("shared.", "encoder.")


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The encoder's tensors of a .safetensors file (names starting with
    "shared." or "encoder."), as f32 numpy. The format: an 8-byte little-endian header
    length, a JSON header {name: {dtype, shape, data_offsets}}, then the raw
    little-endian tensors, at offsets from the header's end."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__" or not name.startswith(_ENCODER_KEYS):
                continue
            begin, end = info["data_offsets"]
            f.seek(8 + n + begin)
            raw = np.frombuffer(f.read(end - begin), np.uint8)
            dt = info["dtype"]
            if dt == "F32":
                a = raw.view("<f4")
            elif dt == "F16":
                a = raw.view("<f2").astype(np.float32)
            elif dt == "BF16":
                a = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
            else:
                raise NotImplementedError(f"{path}: tensor {name} of dtype {dt} "
                                          "(F32, F16 and BF16 are read)")
            out[name] = np.array(a.reshape(info["shape"]), np.float32)
    return out


def read_snapshot_weights(path: str) -> Dict[str, np.ndarray]:
    """The encoder's tensors of an HF snapshot directory, as f32 numpy:
    model.safetensors where there is one, else pytorch_model.bin."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(pt):
        raise FileNotFoundError(f"{path}: neither model.safetensors nor pytorch_model.bin")
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items() if k.startswith(_ENCODER_KEYS)}


# ---------------------------------------------------------------------------
# Online sentence encoders (serving front end)
# ---------------------------------------------------------------------------


def encode_sentences(model: T5Encoder, tokenizer, sentences: List[str],
                     max_tokens: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize on the host, run `model` on its device -> (token_embeds
    [N, T, E] f32, token_mask [N, T] bool)."""
    toks = tokenizer(list(sentences), return_tensors="np", padding="max_length",
                     truncation=True, max_length=max_tokens)
    ids = np.asarray(toks["input_ids"], np.int64)
    mask = np.asarray(toks["attention_mask"], np.int64)
    dev = model.token_embed.device
    with torch.no_grad():
        out = model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return out.float().cpu().numpy(), mask.astype(bool)


class T5OnlineEncoder:
    """Frozen-T5 sentence encoder for out-of-vocabulary queries.

    `encode(sentences)` tokenizes on the host and runs the forward on
    `device`, returning the layout the precomputed table serves for
    in-vocabulary hints (token_embeds [N, T, E], token_mask [N, T]), so
    `Localizer` takes either. The JAX encoder pads a batch to a power of two
    to reuse its compiled program; eager PyTorch compiles nothing per shape
    and the batch's rows are independent, so a batch runs at its own size.
    The parameters never change after load. `device` defaults to the CUDA
    card, and a CUDA device without a card raises: pass "cpu" to run on
    the CPU."""

    def __init__(self, params: Dict, cfg: T5Config, tokenizer, max_tokens: int = 32,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("T5OnlineEncoder(device='cuda'): no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_tokens = int(max_tokens)
        self.model = T5Encoder(cfg, device=self.device).load_params(params).eval()

    @property
    def embed_dim(self) -> int:
        return self.cfg.d_model

    @classmethod
    def from_snapshot(cls, model_name_or_path: str, max_tokens: int = 32,
                      dtype: str = "float32", device="cuda") -> "T5OnlineEncoder":
        """Load a local HF snapshot directory: config.json, the weights
        (read_snapshot_weights) and tokenizer.json."""
        from text2loc_tpu_torch.tokenizer import UnigramTokenizer

        with open(os.path.join(model_name_or_path, "config.json")) as f:
            config = json.load(f)
        params, cfg = convert_t5_encoder(
            read_snapshot_weights(model_name_or_path),
            max_distance=config.get("relative_attention_max_distance", 128))
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tokenizer = UnigramTokenizer.from_file(
            os.path.join(model_name_or_path, "tokenizer.json"))
        return cls(params, cfg, tokenizer, max_tokens=max_tokens, device=device)

    def encode(self, sentences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """sentences -> (token_embeds [N, T, E] f32, token_mask [N, T] bool)."""
        if len(sentences) == 0:
            return (np.zeros((0, self.max_tokens, self.embed_dim), np.float32),
                    np.zeros((0, self.max_tokens), bool))
        return encode_sentences(self.model, self.tokenizer, sentences, self.max_tokens)


class CompositionalOnlineEncoder:
    """Stand-in online encoder matched to `HintTextEmbedder.compositional`.

    In-vocabulary template sentences produce bit-identical embeddings to the
    compositional table (it re-renders through the same word table), so the
    table fast path and the online fallback agree exactly; other sentences
    embed word by word with deterministic seeded-hash vectors. Used where no
    T5 snapshot exists (tests, offline demos)."""

    def __init__(self, embed_dim: int = 1024, max_tokens: int = 16, seed: int = 17):
        from text2loc_tpu_torch.models.text_embedding import compositional_table

        self._table_np, self._tmask_np = compositional_table(embed_dim, max_tokens, seed)
        self.embed_dim = embed_dim
        self.max_tokens = max_tokens
        self._seed = seed

    def _word_vec(self, word: str) -> np.ndarray:
        import hashlib

        h = int.from_bytes(
            hashlib.sha256(f"{self._seed}:{word}".encode()).digest()[:8], "little")
        return np.random.default_rng(h).standard_normal(self.embed_dim).astype(np.float32)

    def encode(self, sentences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        from text2loc_tpu_torch import constants as C
        from text2loc_tpu_torch.text import HintParseError, parse_hint

        n = len(sentences)
        emb = np.zeros((n, self.max_tokens, self.embed_dim), np.float32)
        mask = np.zeros((n, self.max_tokens), bool)
        for i, s in enumerate(sentences):
            try:
                d, c, l = parse_hint(s)
                hid = int(C.hint_id(d, c, l))
                emb[i], mask[i] = self._table_np[hid], self._tmask_np[hid]
            except HintParseError:
                words = s.replace(".", " .").split()[: self.max_tokens]
                for j, w in enumerate(words):
                    emb[i, j] = self._word_vec(w)
                mask[i, : len(words)] = True
        return emb, mask

