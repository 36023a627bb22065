"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for f32 matrix products and convolutions;
2. build: nvcc builds the four kernels from text2loc_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, bf16 and f32, with median times by CUDA events;
4. serve: the cached serve (Localizer.localize) at the full width of the
   default Config (bf16) over a 64-cell synthetic map with seeded random
   weights; batches of 1, 8 and 64 queries; every kernel's launch count
   during the build and the queries must be > 0;
5. serve_vs_cpu: the same weights in f32 on the card and on the CPU (plain
   versions) over an 8-cell map: equal top-1 cells where the top-1/top-2
   score margin exceeds 1e-4, positions within 1e-2 m.

Then the kernels line (launches: the count during phase 4; max_abs_err, ms
and plain_ms: the largest error and the summed medians over the kernel's
bf16 cases of phase 3, FPS's f32 case), the card's nvidia-smi line and,
last, the result line. Any failed check raises: the script exits non-zero and prints no
result. It imports nothing of JAX.
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


class KernelRecord:
    """Errors and times of one kernel over its main-path shapes."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.ms = 0.0
        self.plain_ms = 0.0

    def add(self, name, dtype, got, want, kernel_fn, plain_fn, exact=False):
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        peak = want.abs().max().item() if want.numel() else 0.0
        bound = 0.0 if exact else TOLERANCE[dtype] * peak
        ok = bool(torch.isfinite(got).all()) and err <= bound
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        emit({"phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
              "max_abs_err": err, "bound": bound, "ms": ms, "plain_ms": plain_ms,
              "ok": ok})
        check(ok, f"{name} {dtype}: error {err} above {bound}")
        if dtype == torch.bfloat16 or exact:
            self.max_abs_err = max(self.max_abs_err, err)
            self.ms += ms
            self.plain_ms += plain_ms


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version at the shapes of a 64-cell gallery
    (1792 clouds of 256 points) and a 64-query batch with top-10."""
    from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_mha,
                                        cuda_pointconv, ffn, fps, mha, pointconv)

    gen = torch.Generator().manual_seed(SEED)
    records = {k: KernelRecord() for k in ("fps", "sa", "mha", "ffn")}

    n, p = 64 * 28, 256
    pts = _clouds(gen, n, p, dev)
    idx, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    want_idx, want_xyz = fps.farthest_point_sampling_plain(pts, 128)
    check(torch.equal(idx, want_idx), "fps: indices differ from the plain version")
    records["fps"].add("fps 1792x256->128", torch.float32, xyz, want_xyz,
                       lambda: cuda_fps.farthest_point_sampling_cuda(pts, 128),
                       lambda: fps.farthest_point_sampling_plain(pts, 128), exact=True)

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
            records["sa"].add(
                f"sa_select_first P={lp} S={s} {cin}->{h1}->{h2}", dt,
                cuda_pointconv.sa_select_first_cuda(*args),
                pointconv.sa_select_first_plain(*args),
                lambda a=args: cuda_pointconv.sa_select_first_cuda(*a),
                lambda a=args: pointconv.sa_select_first_plain(*a))
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
            records["mha"].add(
                f"mha_addln {name} B={b} Lq={lq} Lk={lk} D={d}", dt,
                cuda_mha.mha_addln_cuda(*args, num_heads=4),
                mha.mha_addln_plain(*args, num_heads=4),
                lambda a=args: cuda_mha.mha_addln_cuda(*a, num_heads=4),
                lambda a=args: mha.mha_addln_plain(*a, num_heads=4))

    ffn_cases = [("cct", 640 * 16, 128, 512), ("obj_inter", 64 * 28, 256, 512),
                 ("inter head", 64 * 6, 256, 1024)]
    for dt in (torch.bfloat16, torch.float32):
        for name, rows, d, f in ffn_cases:
            args = (_rand(gen, (rows, d), 1.0, dev).to(dt),
                    _rand(gen, (d, f), d ** -0.5, dev), _rand(gen, f, 0.1, dev),
                    _rand(gen, (f, d), f ** -0.5, dev), _rand(gen, d, 0.1, dev),
                    _rand(gen, d, 0.1, dev, 1.0), _rand(gen, d, 0.1, dev))
            records["ffn"].add(
                f"ffn_addln {name} R={rows} D={d} F={f}", dt,
                cuda_ffn.ffn_addln_cuda(*args), ffn.ffn_addln_plain(*args),
                lambda a=args: cuda_ffn.ffn_addln_cuda(*a),
                lambda a=args: ffn.ffn_addln_plain(*a))
    torch.cuda.synchronize()
    return records


# -------------------------------------------------------------------- serve


def _map(num_scenes: int, num_cells: int, cfg):
    from text2loc_tpu.data.arrays import MultiSceneArrays
    from text2loc_tpu.data.synthetic import make_scene

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


def phase_serve(dev, kernels) -> None:
    from text2loc_tpu.config import Config
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


def phase_serve_vs_cpu(dev) -> None:
    import dataclasses

    from text2loc_tpu.config import Config
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 2
    from text2loc_tpu_torch.ops import cuda_ffn, cuda_fps, cuda_mha, cuda_pointconv

    kernels = [cuda_fps.KERNEL, cuda_pointconv.KERNEL, cuda_mha.KERNEL, cuda_ffn.KERNEL]
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    phase_serve(dev, kernels)
    launches = {k.name: k.launches for k in kernels}
    phase_serve_vs_cpu(dev)
    rec = dict(zip((k.name for k in kernels), records.values()))
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": rec[k.name].max_abs_err,
         "ms": rec[k.name].ms, "plain_ms": rec[k.name].plain_ms}
        for k in kernels
    ]})
    check("jax" not in sys.modules, "the port pulled in jax")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
