"""Time the stock attention's grouped fold against the per-sample stock
attention on the card, where the port's stock attention runs by default:
the E=1024 intra stack of the f32 Config() text towers (4 heads, 16 tokens
a sentence; its f32 attention gate at d > 256 is closed).

    python3 scripts/probe_torch_grouped.py [--reps 20] [--cells 64] [--queries 1,16,128]

The fold is the JAX package's grouped_dot_product_attention (its
TEXT2LOC_GROUPED_ATTN switch): G = 128 // max(Lq, Lk) samples folded into
one dense [G Lq, G Lk] product a head, the other samples' keys masked at
-2e9. This script holds its own copy of it, op for op, so that it times
the same thing whatever the port does with it.

The serve (serving.Localizer, f32 Config() models with random weights from
a seed, --cells cells of one synthetic scene) runs the intra stack in two
places: at its build, over the closed hint vocabulary (the two sentence
tables, build_vocab_sentence_table), and per request in localize_embedded
(the cached serve of hint triples gathers from the tables and runs no
text trunk). One JSON line for the tables and one for each request size
in --queries, each with:

- `calls`: the stock attention's calls, and for each call shape (B, Lq,
  Lk, D, heads) `stock_ms` / `fold_ms`: the block (projections, attention,
  output projection) per CUDA event pair, median of --reps, host dispatch
  inside (chip_smoke.cuda_ms), `stock_kernel_ms` / `fold_kernel_ms` with
  the host's dispatch off the span (chip_smoke.kernel_ms), and
  `max_abs_diff` between the two outputs;
- `ms` / `fold_ms`: the whole of it (both tables; one localize_embedded of
  the request) with the port's stock attention and with it replaced by
  the fold, on the host clock around a synchronised call, alternated
  stock, fold, fold, stock, median of --reps each.

The first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fold_attention(query, key, value, mask=None, group_rows: int = 128):
    """[B, Lq, H, DH] by the sample fold: the JAX package's
    grouped_dot_product_attention, op for op (mask [B, 1, Lq, Lk] bool or
    None)."""
    b, lq, h, dh = query.shape
    lk = key.shape[1]
    g = max(1, group_rows // max(lq, lk))
    pad = (-b) % g
    if pad:
        query, key, value = (torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
                             for t in (query, key, value))
        if mask is not None:
            mask = torch.cat([mask, mask.new_zeros((pad, *mask.shape[1:]))])
    nb = query.shape[0] // g
    qf = query.reshape(nb, g * lq, h, dh)
    kf = key.reshape(nb, g * lk, h, dh)
    vf = value.reshape(nb, g * lk, h, dh)
    scores = torch.einsum("nqhd,nkhd->nhqk", qf.float(), kf.float()) / torch.tensor(
        math.sqrt(dh), dtype=torch.float32, device=query.device)

    def fold(x):   # [nb, g, g, Lq, Lk] -> [nb, 1, g Lq, g Lk]
        return x.transpose(2, 3).reshape(nb, 1, g * lq, g * lk)

    if mask is not None:
        km = mask[:, 0].reshape(nb, g, lq, lk)[:, None].expand(nb, g, g, lq, lk)
        scores = scores.masked_fill(~fold(km), -1e9)
    eye = torch.eye(g, dtype=torch.bool, device=query.device)
    block = eye[None, :, :, None, None].expand(nb, g, g, lq, lk)
    scores = scores.masked_fill(~fold(block), -2e9)
    weights = torch.softmax(scores, dim=-1).to(query.dtype)
    out = torch.einsum("nhqk,nkhd->nqhd", weights, vf).reshape(nb * g, lq, h, dh)
    return out[:b] if pad else out


def folded_stock_attention(x, kv, p, key_mask, dtype, dropout, *rest):
    """The port's _stock_attention in eval with the fold in place of the
    per-sample attention."""
    b, lq, d = x.shape
    lk = kv.shape[1]
    h = p.num_heads
    dh = d // h
    q = p.query(x, dtype).reshape(b, lq, h, dh)
    k = p.key(kv, dtype).reshape(b, lk, h, dh)
    v = p.value(kv, dtype).reshape(b, lk, h, dh)
    mask = (None if key_mask is None
            else key_mask.to(torch.bool)[:, None, None, :].expand(b, 1, lq, lk))
    return p.out(fold_attention(q, k, v, mask).reshape(b, lq, d), dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--queries", default="1,16,128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_grouped: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.retrieval import build_vocab_sentence_table
    from text2loc_tpu_torch.models import transformer
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, dtype="float32"))
    data = smoke._map(1, args.cells, cfg)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    coarse, fine = smoke._models(cfg, torch.Generator().manual_seed(smoke.SEED + 1))
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=5, device=dev)
    stock = transformer._stock_attention

    def tables():
        build_vocab_sentence_table(loc.embedder, loc.coarse_model.encode_text_sentences)
        build_vocab_sentence_table(loc.embedder, loc.fine_model.encode_hints)

    work = [("tables", tables)]
    for nq in (int(n) for n in args.queries.split(",")):
        q = np.arange(nq) % data.num_poses
        text = emb.embed(data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                         data.hint_mask[q])
        embedded = (text.token_embeds.cpu().numpy(), text.token_mask.cpu().numpy(),
                    text.sentence_mask.cpu().numpy())
        work.append((nq, lambda e=embedded: loc.localize_embedded(*e)))
    for what, run in work:
        calls = []

        def recording(*a, **kw):
            calls.append(a)
            return stock(*a, **kw)

        transformer._stock_attention = recording
        try:
            with torch.no_grad():
                run()
        finally:
            transformer._stock_attention = stock
        shapes = []
        seen = set()
        for a in calls:
            x, kv, p = a[0], a[1], a[2]
            shape = (x.shape[0], x.shape[1], kv.shape[1], x.shape[2], p.num_heads)
            if shape in seen:
                continue
            seen.add(shape)
            with torch.no_grad():
                shapes.append({
                    "shape": shape,
                    "max_abs_diff": float((stock(*a) - folded_stock_attention(*a)).abs().max()),
                    "stock_ms": smoke.cuda_ms(lambda a=a: stock(*a), args.reps),
                    "fold_ms": smoke.cuda_ms(lambda a=a: folded_stock_attention(*a), args.reps),
                    "stock_kernel_ms": smoke.kernel_ms(lambda a=a: stock(*a), args.reps),
                    "fold_kernel_ms": smoke.kernel_ms(lambda a=a: folded_stock_attention(*a),
                                                      args.reps)})

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                run()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        times = {"stock": [], "fold": []}
        timed()
        for _ in range(args.reps):
            for kind in ("stock", "fold", "fold", "stock"):
                transformer._stock_attention = (stock if kind == "stock"
                                                else folded_stock_attention)
                try:
                    times[kind].append(timed())
                finally:
                    transformer._stock_attention = stock
        print(json.dumps({"what": what, "cells": data.num_cells, "calls": len(calls),
                          "shapes": shapes, "ms": statistics.median(times["stock"]),
                          "fold_ms": statistics.median(times["fold"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
