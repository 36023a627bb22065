"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for f32 matrix products and convolutions;
2. build: nvcc builds the six kernels from text2loc_tpu_torch/csrc;
3. kernels: each serve kernel against its plain PyTorch version on the card
   at the serve's shapes, bf16 and f32, with median times by CUDA events;
   then the training SA level (sa_train_fwd, sa_train_bwd) against its
   plain forward and hand-derived plain backward at the coarse train
   step's three levels (896 clouds, K=32), f32 and bf16;
4. serve: the cached serve (Localizer.localize) at the full width of the
   default Config (bf16) over a 64-cell synthetic map with seeded random
   weights; batches of 1, 8 and 64 queries; every serve kernel's launch
   count during the build and the queries must be > 0;
5. serve_vs_cpu: the same weights in f32 on the card and on the CPU (plain
   versions) over an 8-cell map: equal top-1 cells where the top-1/top-2
   score margin exceeds 1e-4, positions within 1e-2 m;
6. train: train_coarse at the full width of the default Config (f32 body)
   on a 96-pose synthetic map, batch 32, 3 steps, then 2 fine train steps
   at pad_size 16: step times, peak memory, losses; losses finite, every
   parameter with a nonzero gradient changed (all three SA levels among
   them), BN running statistics moved, fps / sa_train_fwd / sa_train_bwd
   launched;
7. train_vs_cpu: one coarse step (batch 8, dropout 0, no augmentation, f32)
   from the same seeded weights on the card and on the CPU: loss, every
   gradient leaf and the BN running statistics.

Then the kernels line (launches: the counts during phases 4 and 6, each
path's counts set to 0 just before it; max_abs_err, ms, plain_ms and
bound_ms: over the serve kernels' bf16 cases of phase 3, FPS's f32 case,
and the training kernels' f32 cases, the path's dtypes), the card's
nvidia-smi line and, last, the result line. Any failed check raises: the
script exits non-zero and prints no result. It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # x max|plain|
REL_L2 = {torch.bfloat16: 2e-2, torch.float32: 1e-3}     # x ||plain|| (SA_TRAIN_GRAD_FLOOR)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of fn() on the card, by CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build() -> None:
    from text2loc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_cuda.build())})


# ------------------------------------------------------------------ kernels


def _clouds(gen, n, p, dev):
    pts = torch.randn(n, p, 3, generator=gen) * torch.rand(n, 1, 3, generator=gen)
    pts = pts - pts.mean(dim=1, keepdim=True)
    pts = pts / pts.abs().amax(dim=(1, 2), keepdim=True) * 0.999999
    return pts.to(dev).contiguous()


def _rand(gen, shape, scale, dev, mean=0.0):
    return (torch.randn(shape, generator=gen) * scale + mean).to(dev)


# Published peaks of one H100 SXM (dense): f32 outside the tensor cores,
# bf16 tensor cores, HBM bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype):
    """(op seconds, byte seconds): the least time of the work on the card
    is the larger of the two."""
    return flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S


class KernelRecord:
    """Errors, times and bounds of one kernel over its main-path cases."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.ms = 0.0
        self.plain_ms = 0.0
        self.bound_ms = 0.0
        self.op_s = 0.0
        self.byte_s = 0.0

    @property
    def bound_by(self) -> str:
        return "operations" if self.op_s >= self.byte_s else "bytes"

    def add(self, name, dtype, pairs, kernel_fn, plain_fn, work, exact=False,
            norm_floor=None, counts=None):
        """pairs: [(kernel output, plain output)], each within TOLERANCE x
        max|plain| (0 when exact); work: (FLOPs, bytes, dtype of the products)
        of the case. With `norm_floor` the check is instead ||kernel - plain||
        <= REL_L2[dtype] x max(||plain||, norm_floor) per pair."""
        err, ok, limit, rels = 0.0, True, 0.0, []
        for got, want in pairs:
            got, want = got.float(), want.float()
            e = (got - want).abs().max().item() if got.numel() else 0.0
            peak = want.abs().max().item() if want.numel() else 0.0
            lim = 0.0 if exact else TOLERANCE[dtype] * peak
            if norm_floor is None:
                good = e <= lim
            else:
                r = ((got - want).norm() / max(want.norm().item(), norm_floor)).item()
                rels.append(r)
                lim = REL_L2[dtype]
                good = r <= lim
            ok = ok and bool(torch.isfinite(got).all()) and good
            if e >= err:
                err, limit = e, lim
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        op_s, byte_s = bound(*work)
        bound_ms = max(op_s, byte_s) * 1e3
        emit({"phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
              "max_abs_err": err, "bound": limit, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": "operations" if op_s >= byte_s else "bytes",
              "ok": ok, **({"rel_l2_errs": rels} if norm_floor is not None else {})})
        check(ok, f"{name} {dtype}: error {err} above {limit}")
        if counts if counts is not None else (dtype == torch.bfloat16 or exact):
            self.max_abs_err = max(self.max_abs_err, err)
            self.ms += ms
            self.plain_ms += plain_ms
            self.bound_ms += bound_ms
            self.op_s += op_s
            self.byte_s += byte_s


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version at the shapes of a 64-cell gallery
    (1792 clouds of 256 points) and a 64-query batch with top-10."""
    from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_mha,
                                        cuda_pointconv, ffn, fps, mha, pointconv)
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    gen = torch.Generator().manual_seed(SEED)
    records = {k: KernelRecord() for k in ("fps", "sa", "mha", "ffn")}

    n, p = 64 * 28, 256
    pts = _clouds(gen, n, p, dev)
    idx, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    want_idx, want_xyz = fps.farthest_point_sampling_plain(pts, 128)
    check(torch.equal(idx, want_idx), "fps: indices differ from the plain version")
    # 3 subtractions, 3 products and 2 sums per point and round.
    records["fps"].add("fps 1792x256->128", torch.float32, [(xyz, want_xyz)],
                       lambda: cuda_fps.farthest_point_sampling_cuda(pts, 128),
                       lambda: fps.farthest_point_sampling_plain(pts, 128),
                       (8.0 * n * 127 * p, n * p * 12 + n * 128 * 16, torch.float32),
                       exact=True)

    levels = [(256, 128, 6, 32, 64, 0.2), (128, 64, 67, 128, 128, 0.3),
              (64, 32, 131, 256, 256, 0.4)]
    for dt in (torch.bfloat16, torch.float32):
        pos = pts
        for lp, s, cin, h1, h2, radius in levels:
            ctr = xyz[:, :s].contiguous()
            feat = torch.cat([_rand(gen, (n, lp, cin - 3), 1.0, dev), pos], -1)
            feat = feat.to(dt).contiguous()
            w1 = _rand(gen, (cin, h1), cin ** -0.5, dev).to(dt)
            w2 = _rand(gen, (h1, h2), h1 ** -0.5, dev).to(dt)
            ab1 = torch.stack([_rand(gen, h1, 0.1, dev, 1.0), _rand(gen, h1, 0.1, dev)])
            ab2 = torch.stack([_rand(gen, h2, 0.1, dev, 1.0), _rand(gen, h2, 0.1, dev)])
            args = (feat, pos, ctr, w1, w1[cin - 3:].contiguous(), ab1.contiguous(),
                    w2, ab2.contiguous(), radius, 32)
            # Products: u = feat @ W1 per point, the center term, the second
            # layer over the selected edges of this data.
            edges = ball_query_knn(pos, ctr, radius, 32, first=True)[1].sum().item()
            es = feat.element_size()
            work = (2.0 * (n * lp * cin * h1 + n * s * 3 * h1 + edges * h1 * h2),
                    n * lp * (cin * es + 12) + n * s * (12 + h2 * es)
                    + (cin * h1 + h1 * h2) * es + 8 * (h1 + h2), dt)
            records["sa"].add(
                f"sa_select_first P={lp} S={s} {cin}->{h1}->{h2}", dt,
                [(cuda_pointconv.sa_select_first_cuda(*args),
                  pointconv.sa_select_first_plain(*args))],
                lambda a=args: cuda_pointconv.sa_select_first_cuda(*a),
                lambda a=args: pointconv.sa_select_first_plain(*a), work)
            pos = ctr

    # (name, B, Lq, Lk, D, self-attention, one sample with every key masked)
    attn_cases = [("cct obj cross", 640, 16, 6, 128, False, False),
                  ("cct hint cross", 640, 6, 16, 128, False, False),
                  ("cct obj self", 640, 16, 16, 128, True, False),
                  ("cct hint self", 64, 6, 6, 128, True, True),
                  ("obj_inter", 64, 28, 28, 256, True, False),
                  ("inter head", 64, 6, 6, 256, True, False),
                  ("intra E=1024", 1584, 16, 16, 1024, True, False)]
    for dt in (torch.bfloat16, torch.float32):
        for name, b, lq, lk, d, self_attn, empty in attn_cases:
            if d > 256 and dt == torch.float32:
                continue      # f32 at d=1024 runs stock ops, as in the JAX gate
            x = _rand(gen, (b, lq, d), 1.0, dev).to(dt)
            kv = x if self_attn else _rand(gen, (b, lk, d), 1.0, dev).to(dt)
            mats = [_rand(gen, (d, d), d ** -0.5, dev) for _ in range(4)]
            vecs = [_rand(gen, d, 0.1, dev) for _ in range(4)]
            mask = torch.rand(b, lk, generator=gen).to(dev) > 0.25
            mask[:, 0] = True
            if empty:
                mask[0] = False   # attends uniformly over its own keys
            args = (x, kv, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2],
                    mats[3], vecs[3], _rand(gen, d, 0.1, dev, 1.0),
                    _rand(gen, d, 0.1, dev), mask)
            es = x.element_size()
            work = (2.0 * (2 * b * lq * d * d + 2 * b * lk * d * d + 2 * b * lq * lk * d),
                    2 * b * lq * d * es + (0 if self_attn else b * lk * d * es)
                    + 4 * d * d * 4 + 6 * d * 4 + b * lk, dt)
            records["mha"].add(
                f"mha_addln {name} B={b} Lq={lq} Lk={lk} D={d}", dt,
                [(cuda_mha.mha_addln_cuda(*args, num_heads=4),
                  mha.mha_addln_plain(*args, num_heads=4))],
                lambda a=args: cuda_mha.mha_addln_cuda(*a, num_heads=4),
                lambda a=args: mha.mha_addln_plain(*a, num_heads=4), work)

    ffn_cases = [("cct", 640 * 16, 128, 512), ("obj_inter", 64 * 28, 256, 512),
                 ("inter head", 64 * 6, 256, 1024)]
    for dt in (torch.bfloat16, torch.float32):
        for name, rows, d, f in ffn_cases:
            args = (_rand(gen, (rows, d), 1.0, dev).to(dt),
                    _rand(gen, (d, f), d ** -0.5, dev), _rand(gen, f, 0.1, dev),
                    _rand(gen, (f, d), f ** -0.5, dev), _rand(gen, d, 0.1, dev),
                    _rand(gen, d, 0.1, dev, 1.0), _rand(gen, d, 0.1, dev))
            es = args[0].element_size()
            work = (4.0 * rows * d * f, 2 * rows * d * es + 2 * d * f * 4 + (f + 3 * d) * 4,
                    dt)
            records["ffn"].add(
                f"ffn_addln {name} R={rows} D={d} F={f}", dt,
                [(cuda_ffn.ffn_addln_cuda(*args), ffn.ffn_addln_plain(*args))],
                lambda a=args: cuda_ffn.ffn_addln_cuda(*a),
                lambda a=args: ffn.ffn_addln_plain(*a), work)
    torch.cuda.synchronize()
    return records


# The training SA level's gradients are checked by relative L2 error, not
# by the largest element: the backward of the neighbour max and of the
# ReLUs is discontinuous, and the kernel's z differs from the plain
# version's in the last bits (another order of sums), so at a few of the
# millions of (center, channel) pairs a near-tie picks another winning
# edge, or a pre-activation within an ulp of 0 falls on the other side;
# each such flip moves O(1) of gradient between edges, and neither side is
# the more exact one at such a tie. Gradients whose exact value is
# near zero (db2, BN shift invariance) are sums of cancelling terms: their
# norm is floored at 1e-3 x the largest gradient norm of the case.
SA_TRAIN_GRAD_FLOOR = 1e-3


def phase_sa_train_kernels(dev) -> dict:
    """sa_train_fwd / sa_train_bwd against the plain forward and the plain
    hand-derived backward at the coarse train step's three levels: 896
    clouds (32 cells x 28 objects, a quarter of them padding objects out
    of the statistics), exact nearest-32 neighbours from the real ball
    query of FPS centers, random u / sv / weights and cotangent."""
    from text2loc_tpu_torch.ops import cuda_fps, cuda_sa_train, sa_train
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    gen = torch.Generator().manual_seed(SEED + 3)
    records = {"sa_train_fwd": KernelRecord(), "sa_train_bwd": KernelRecord()}
    n, k = 32 * 28, 32
    pts = _clouds(gen, n, 256, dev)
    _, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    obj = (torch.arange(n, device=dev) % 28) < 21
    levels = [(256, 128, 32, 64, 0.2), (128, 64, 128, 128, 0.3), (64, 32, 256, 256, 0.4)]
    pos = pts
    for p, s, h1, h2, radius in levels:
        ctr = xyz[:, :s].contiguous()
        idx, maskm = ball_query_knn(pos, ctr, radius, k)
        idx = idx.to(torch.int32).contiguous()
        maskf = maskm & obj[:, None, None]
        edges = maskm.sum().item()
        u = _rand(gen, (n, p, h1), 1.0, dev)
        sv = _rand(gen, (n, s, h1), 0.5, dev)
        w2 = _rand(gen, (h1, h2), h1 ** -0.5, dev)
        b2, be1, be2 = (_rand(gen, h, 0.1, dev) for h in (h2, h1, h2))
        g1, g2 = (_rand(gen, h, 0.1, dev, 1.0) for h in (h1, h2))
        dout = _rand(gen, (n, s, h2), 1.0, dev)
        io_bytes = (n * p * h1 + n * s * h1 + h1 * h2) * 4 + n * s * k * 6
        for dt in (torch.float32, torch.bfloat16):
            tag = f"P={p} S={s} K={k} H={h1}->{h2} edges={edges}"

            def fwd(dt=dt):
                level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt)
                return sa_train.forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5)

            out, stats, aux1, aux2 = fwd()
            want_out, want_stats = sa_train.sa_train_plain(
                u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, compute_dtype=dt)
            records["sa_train_fwd"].add(
                f"sa_train_fwd {tag}", dt,
                [(out, want_out)] + list(zip(stats, want_stats)), fwd,
                lambda dt=dt: sa_train.sa_train_plain(
                    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, compute_dtype=dt),
                (2.0 * edges * h1 * h2, io_bytes + n * s * h2 * 4, dt),
                counts=dt == torch.float32)
            level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt)
            n1 = stats[4]
            got = sa_train.backward_cuda(level, aux1, aux2, n1, dout)
            want = sa_train.sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1,
                                                    aux2, n1, dout, dt)
            floor = SA_TRAIN_GRAD_FLOOR * max(w.norm().item() for w in want)
            records["sa_train_bwd"].add(
                f"sa_train_bwd {tag}", dt, list(zip(got, want)),
                lambda lv=level, a1=aux1, a2=aux2, c=n1: sa_train.backward_cuda(
                    lv, a1, a2, c, dout),
                lambda dt=dt, a1=aux1, a2=aux2, c=n1: sa_train.sa_train_backward_plain(
                    u, sv, w2, idx, maskm, maskf, a1, a2, c, dout, dt),
                (4.0 * edges * h1 * h2,
                 io_bytes + n * s * h2 * 4
                 + (n * p * h1 + n * s * h1 + h1 * h2 + 2 * h1 + 3 * h2) * 4, dt),
                norm_floor=floor, counts=dt == torch.float32)
        pos = ctr
    torch.cuda.synchronize()
    return records


# -------------------------------------------------------------------- serve


def _map(num_scenes: int, num_cells: int, cfg):
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = cfg.model
    return MultiSceneArrays([
        make_scene(f"{i:04d}", num_cells=num_cells, num_poses=2 * num_cells,
                   object_slots=m.object_size, num_points=m.pointnet.num_points,
                   num_mentioned=m.num_mentioned, seed=SEED + i)
        for i in range(num_scenes)
    ])


def _models(cfg, gen):
    from text2loc_tpu_torch.convert import build_model, init_weights

    return (init_weights(build_model(cfg, "coarse"), gen),
            init_weights(build_model(cfg, "fine"), gen))


def _check_result(res, data, b, k):
    check(res.position_w.shape == (b, 2), f"position_w {res.position_w.shape}")
    check(res.candidates_w.shape == (b, k, 2), f"candidates {res.candidates_w.shape}")
    check(res.cell_indices.shape == (b, k), f"cells {res.cell_indices.shape}")
    check(bool(np.isfinite(res.candidates_w).all() and np.isfinite(res.scores).all()),
          "non-finite serve output")
    check(bool((np.diff(res.scores, axis=1) <= 1e-6).all()), "scores not descending")
    bbox = data.cell_bbox[res.cell_indices]
    for axis, (lo, hi) in enumerate(((0, 3), (1, 4))):
        c = res.candidates_w[..., axis]
        check(bool(((c >= bbox[..., lo] - 15.0) & (c <= bbox[..., hi] + 15.0)).all()),
              "candidate outside its cell's bbox +- 15 m")


def phase_serve(dev, kernels) -> dict:
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    cfg = Config()
    data = _map(2, 32, cfg)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED))
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    latency = {}
    for b in (1, 8, 64):
        q = np.arange(b) % data.num_poses
        args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q],
                data.hint_mask[q])
        res = loc.localize(*args)
        _check_result(res, data, b, loc.top_k)
        times = []
        for _ in range(20):
            t = time.perf_counter()
            loc.localize(*args)
            times.append((time.perf_counter() - t) * 1e3)
        latency[str(b)] = statistics.median(times)
    counts = {k.name: k.launches for k in kernels}
    emit({"phase": "serve", "config": "Config() bf16", "cells": data.num_cells,
          "top_k": loc.top_k, "build_s": build_s, "median_ms_per_batch": latency,
          "launches": counts})
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    return counts


def phase_serve_vs_cpu(dev) -> None:
    import dataclasses

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, dtype="float32"))
    data = _map(1, 8, cfg)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    q = np.arange(16) % data.num_poses
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    results = {}
    for where in ("cuda", "cpu"):
        coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 1))
        loc = Localizer(data, coarse, fine, emb, cfg, top_k=5,
                        device=dev if where == "cuda" else "cpu")
        results[where] = loc.localize(*args)
    gpu, cpu = results["cuda"], results["cpu"]
    margin = cpu.scores[:, 0] - cpu.scores[:, 1]
    sure = margin > 1e-4
    top1_equal = bool((gpu.cell_indices[sure, 0] == cpu.cell_indices[sure, 0]).all())
    same = sure & (gpu.cell_indices[:, 0] == cpu.cell_indices[:, 0])
    pos_err = float(np.abs(gpu.position_w[same] - cpu.position_w[same]).max())
    emit({"phase": "serve_vs_cpu", "cells": data.num_cells, "queries": len(q),
          "compared": int(sure.sum()), "top1_equal": top1_equal,
          "max_pos_err_m": pos_err,
          "max_score_err": float(np.abs(gpu.scores - cpu.scores).max())})
    check(top1_equal, "top-1 cell differs between the card and the CPU")
    check(int(same.sum()) > 0 and pos_err <= 1e-2,
          f"positions differ by {pos_err} m between the card and the CPU")


# -------------------------------------------------------------------- train


def _train_cfg(batch_size: int, epochs: int = 1, plain: bool = False):
    """The default Config (full widths, f32 body) with the batch size set;
    `plain`: dropout 0 and no augmentation."""
    import dataclasses

    from text2loc_tpu_torch.config import Config

    cfg = Config()
    train = dataclasses.replace(cfg.train, batch_size=batch_size, epochs=epochs)
    model = cfg.model
    if plain:
        model = dataclasses.replace(model, dropout_rate=0.0)
        train = dataclasses.replace(train, flip_poses=False, shuffle_hints=False,
                                    pc_augment=False, fine_flip_poses=False)
    # The trainers compute in train_dtype (f32); the models are built so.
    model = dataclasses.replace(model, dtype=model.train_dtype)
    return cfg.replace(model=model, train=train)


def _train_map(cfg, num_poses: int):
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = cfg.model
    return MultiSceneArrays([make_scene(
        "0100", num_cells=32, num_poses=num_poses, object_slots=m.object_size,
        num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned, seed=SEED + 5)])


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _check_trained(model, before: dict, what: str) -> dict:
    """Every parameter with a nonzero gradient of the last step changed, all
    SA levels among them; the BN running statistics moved."""
    params = dict(model.named_parameters())
    live = [k for k, p in params.items()
            if p.grad is not None and bool(p.grad.abs().sum() > 0)]
    stuck = [k for k in live if torch.equal(params[k].detach(), before[k])]
    check(not stuck, f"{what}: parameters with gradients did not change: {stuck[:5]}")
    fused = [k for k in live if ".sa" in k and ".dense_1.weight" in k]
    stats = [k for k in before if k.endswith("running_mean")]
    moved = [k for k in stats if not torch.equal(model.state_dict()[k], before[k])]
    check(len(moved) == len(stats), f"{what}: BN statistics did not move: "
          f"{sorted(set(stats) - set(moved))[:5]}")
    return {"params_with_grad": len(live), "sa_levels_with_grad": len(fused),
            "bn_stats_moved": len(moved)}


def phase_train(dev, kernels) -> dict:
    """train_coarse for 3 steps and 2 fine train steps at full width."""
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training import steps as steps_lib
    from text2loc_tpu_torch.training.coarse import train_coarse

    cfg = _train_cfg(batch_size=32)
    data = _train_map(cfg, num_poses=96)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    gen = torch.Generator().manual_seed(SEED + 2)
    coarse = init_weights(build_model(cfg, "coarse"), gen).to(dev)
    fine = init_weights(build_model(cfg, "fine"), gen).to(dev)
    before_c, before_f = _snapshot(coarse), _snapshot(fine)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, history = train_coarse(cfg, data, emb, device=dev, model=coarse)
    coarse_peak = torch.cuda.max_memory_allocated()
    coarse_state = _check_trained(coarse, before_c, "coarse")

    torch.cuda.reset_peak_memory_stats()
    opt = steps_lib.make_optimizer(fine.parameters(), cfg, steps_per_epoch=3)
    step = steps_lib.make_fine_train_step(fine, emb, cfg, opt,
                                          torch.Generator(device=dev).manual_seed(SEED))
    fine_hist = []
    for i in range(2):
        batch = data.gather_fine(np.arange(32 * i, 32 * (i + 1)), cfg.model.pad_size)
        t0 = time.perf_counter()
        m = step(batch)
        fine_hist.append({"loss": float(m["loss"]), "pose_error": float(m["pose_error"]),
                          "seconds": time.perf_counter() - t0})
    fine_peak = torch.cuda.max_memory_allocated()
    fine_state = _check_trained(fine, before_f, "fine")
    counts = {k.name: k.launches for k in kernels}
    losses = [h["loss"] for h in history] + [h["loss"] for h in fine_hist]
    emit({"phase": "train", "config": "Config() f32 body", "poses": data.num_poses,
          "batch": cfg.train.batch_size, "pad_size": cfg.model.pad_size,
          "coarse_steps": len(history),
          "coarse_step_ms": [h["seconds"] * 1e3 for h in history],
          "coarse_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in history),
          "coarse_losses": [h["loss"] for h in history],
          "coarse_peak_mem_gb": coarse_peak / 1e9, "coarse": coarse_state,
          "fine_step_ms": [h["seconds"] * 1e3 for h in fine_hist],
          "fine_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in fine_hist),
          "fine_losses": [h["loss"] for h in fine_hist],
          "fine_pose_error": [h["pose_error"] for h in fine_hist],
          "fine_peak_mem_gb": fine_peak / 1e9, "fine": fine_state, "launches": counts})
    check(len(history) == 3, f"train_coarse took {len(history)} steps, not 3")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(coarse_state["sa_levels_with_grad"] == 3 and fine_state["sa_levels_with_grad"] == 3,
          "an SA level got no gradient")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    return counts


def _grad_report(got: dict, want: dict):
    """Per leaf: relative L2 error and cosine of the card's gradient against
    the CPU's; leaves below 1e-6 x the global gradient norm (BN-shift and
    softmax-shift directions whose exact gradient is 0) only have to stay
    below 10 x that floor on the card."""
    norm = float(torch.sqrt(sum(w.double().pow(2).sum() for w in want.values())))
    floor = 1e-6 * norm
    worst_rel, worst_cos, bad = 0.0, 1.0, []
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        nw = float(w.norm())
        if nw < floor:
            if float(g.norm()) >= 10 * floor:
                bad.append(k)
            continue
        rel = float((g - w).norm()) / nw
        cos = float((g * w).sum() / (g.norm() * w.norm() + 1e-30))
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if not (rel <= 1e-3 or cos >= 0.9999):
            bad.append(k)
    return worst_rel, worst_cos, floor, bad


def phase_train_vs_cpu(dev) -> None:
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training import steps as steps_lib

    cfg = _train_cfg(batch_size=8, plain=True)
    data = _train_map(cfg, num_poses=16)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    batch = data.gather_coarse(np.arange(8), cfg.model.object_size)
    runs = {}
    for where in ("cuda", "cpu"):
        model = init_weights(build_model(cfg, "coarse"),
                             torch.Generator().manual_seed(SEED + 4)).to(where)
        opt = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch=1)
        step = steps_lib.make_coarse_train_step(
            model, emb, cfg, opt, torch.Generator(device=where).manual_seed(SEED))
        loss = float(step(batch)["loss"])
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if "running_" in k}
        runs[where] = (loss, grads, stats)
    (gl, gg, gs), (cl, cg, cs) = runs["cuda"], runs["cpu"]
    loss_rel = abs(gl - cl) / abs(cl)
    worst_rel, worst_cos, floor, bad = _grad_report(gg, cg)
    stat_rel = max(float((gs[k] - cs[k]).norm() / (cs[k].norm() + 1e-30)) for k in cs)
    emit({"phase": "train_vs_cpu", "batch": 8, "loss_cuda": gl, "loss_cpu": cl,
          "loss_rel_err": loss_rel, "grad_leaves": len(cg), "grad_floor": floor,
          "worst_grad_rel_l2": worst_rel, "worst_grad_cos": worst_cos,
          "grad_leaves_failed": bad, "worst_bn_stat_rel": stat_rel})
    check(set(gg) == set(cg), "gradient leaves differ between the card and the CPU")
    check(loss_rel <= 1e-4, f"loss differs by {loss_rel} (rel)")
    check(not bad, f"gradients differ between the card and the CPU: {bad[:5]}")
    check(stat_rel <= 1e-3, f"BN running statistics differ by {stat_rel} (rel)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 2
    from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_mha, cuda_pointconv,
                                        cuda_sa_train)

    serve_kernels = [cuda_fps.KERNEL, cuda_pointconv.KERNEL, cuda_mha.KERNEL,
                     cuda_ffn.KERNEL]
    train_kernels = [cuda_fps.KERNEL, cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD]
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    records = dict(zip((k.name for k in serve_kernels), records.values()))
    records.update(phase_sa_train_kernels(dev))
    serve_counts = phase_serve(dev, serve_kernels)
    phase_serve_vs_cpu(dev)
    train_counts = phase_train(dev, train_kernels)
    phase_train_vs_cpu(dev)
    kernels = serve_kernels + train_kernels[1:]
    launches = {k.name: serve_counts.get(k.name, 0) + train_counts.get(k.name, 0)
                for k in kernels}
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": records[k.name].max_abs_err,
         "ms": records[k.name].ms, "plain_ms": records[k.name].plain_ms,
         "bound_ms": records[k.name].bound_ms, "bound_by": records[k.name].bound_by,
         "library_ms": None}
        for k in kernels
    ]})
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "text2loc_tpu") or m.startswith(("jax.", "text2loc_tpu.")))
    check(not loaded, f"the port pulled in JAX or the JAX package: {loaded[:5]}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
