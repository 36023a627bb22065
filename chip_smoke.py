"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for f32 matrix products and convolutions;
2. build: nvcc builds the kernel sources of text2loc_tpu_torch/csrc (one
   process per source, all at once);
3. kernels: each serve kernel against its plain PyTorch version on the card
   at the serve's shapes, bf16 and f32, with median times by CUDA events;
   the inference SA level in every selection (first, bisect, gather over
   the exact and the approximate ball query, exact, all) at the gallery's
   three levels, on the tensor-core tile kernel, each line with its plan
   (tile rows, W2 resident, shared bytes, blocks per SM, column slices,
   the row map's budget of "all"), the "all" lines with
   their groups, tiles and mean filled rows; and "all" at SA1 with a dense
   cluster whose centers hold more edges than a tile (not summed); the
   attention block by its route (mha_addln, the fused
   kernel, to d=256, each line with kernel_ms, the kernel alone with the
   host's dispatch off the measured span, and stock_ms, and the blocks of
   a batch-1 serve request as lines of their own, not summed;
   mha_addln_tiled, the tiled chain, at the intra stack's E=1024 in bf16
   and f32, with each stage of the chain against its plain stage and, as a
   yardstick the port never calls, stock_ms: the port's fused_attn="0" path
   with cuBLAS products (TF32 off), on every tiled line; the intra lines
   faster than plain and no slower than stock_ms (bf16 also at most 3 ms);
   and at two lengths past the attention core's one-sweep chunk, self
   128x128 and cross 16x600 at E=1024, which take its two sweeps: lines of
   their own, not summed, each stage against its plain stage, faster than
   plain; every tiled line and stage line with the core's plan (core_rows,
   core_chunk, core_sweeps), the project and core stage lines with
   library_ms, one PyTorch call the port never makes: torch.addmm over the
   packed weights, F.scaled_dot_product_attention with the additive key
   bias); the feed-forward block by its route (ffn_addln, the fused kernel,
   to d=256, each line with kernel_ms, stock_ms and its plan (tile rows,
   cluster, blocks), and the blocks of a batch-1 serve request as lines of
   their own, not summed; ffn_addln_tiled, the tiled chain, at the E=1024 trunk's
   R=25,344 rows, D=1024, F=4096 in bf16 and f32, each stage against its
   plain stage through the chain's own stage entries, faster than plain and
   no slower than stock_ms, the port's fused_ffn="0" block, on its line);
   both tiled chains over rows past one warp's LayerNorm (the row routine's
   wide layout): D=2048 in f32 and 4096 in bf16, 16 heads, F = 4D, a few
   hundred rows, lines of their own, not summed, with stock_ms, the f32
   lines faster than plain, the feed-forward chain's stages too. The
   chains' f32 products run as 3xTF32 on the tensor cores, as the fused
   blocks' do: their f32 lines' bound_ms counts the FLOPs at F32_TC_FLOPS;
   each tiled f32 case first
   puts the weights' TF32 split (tf32_split, csrc/tf32_split.cu) on a
   kernel line of its own, bit-equal to its plain version, with kernel_ms,
   the intra cases' lines summed; the stages run on that split; and a
   control line per chain (kernel_control) holds the chain's products on
   TF32 alone (the plain project / hidden stage with allow_tf32 on for that
   line only) against the f32 limit, which they must miss;
   then the training SA level (sa_train_fwd, sa_train_bwd)
   against its plain forward and hand-derived plain backward at the coarse
   train step's three levels (896 clouds, K=32), f32 and bf16 (the f32
   lines' bound_ms at F32_TC_FLOPS, as the inference SA lines' in f32:
   their products run 3xTF32 too), each case
   line with its passes alone (stages: ms of stats1 / stats2 / out for the
   forward, of stats / mid / in for the backward, reduces included) and per
   pass its tiles (count, mean filled rows), blocks_per_sm, tile rows and
   whether W2 sits in shared memory; the backward fed dout with zeros at
   the level's near-ties of the neighbour max (ops/sa_train.near_ties), at
   most 1e-5 of its (cloud, center, column) pairs, with near_ties,
   near_tie_share and the unmasked errors rel_l2_errs_full on its line;
4. serve: the cached serve (Localizer.localize) at the full width of the
   default Config (bf16) over a 64-cell synthetic map with seeded random
   weights; batches of 1, 8 and 64 queries; every serve kernel's launch
   count during the build and the queries must be > 0 (mha_addln and
   mha_addln_tiled among them; ffn_addln_tiled launches 0 times);
4b. trace: one batch-8 localize of phase 4's serve under
   utils/profiling.profile_trace on the card: the *.pt.trace.json it
   writes holds as many kernel events of mha_addln and ffn_addln as their
   launch counters count (a window that lost device events taken again,
   up to TRACE_WINDOWS), and no other kernel launched; the event counts,
   the trace's size and its kernel time on a line with the card's name
   and power limit;
5. serve_vs_cpu: the same weights in f32 on the card and on the CPU (plain
   versions) over an 8-cell map, by path (the cached serve, the stepwise
   path precompute_fine=False, localize_embedded): equal top-1 cells where
   the top-1/top-2 score margin exceeds 1e-4, positions within 1e-2 m;
5b. layers: EncoderLayer and DecoderLayer at d_model 384 and 768 (f32,
   seeded weights), card against CPU within TOLERANCE, under
   fused_attn="all", fused_ffn="all" (mha_addln_tiled and ffn_addln_tiled
   launch, and tf32_split, the split of their f32 weights; add_ln and
   the fused blocks not) and under fused_attn="0",
   fused_ffn="0", fused_ln="all" (add_ln launches, no block kernel);
6. pipeline: run_pipeline (coarse retrieval, fine refinement, the two
   tables) at full Config() width (bf16) over the 64-cell map, once per
   mode of scripts/validate_kernels.py's sweep table: wall seconds,
   fine_qps, top-1 rows, agreement with the "exact" (off) baseline; each
   mode must launch its SA kernels and no other SA kernel, and no opt-in
   kernel (add_ln, gather_rows, ffn_addln_tiled);
7. pipeline_vs_cpu: every mode in f32 on the card and on the CPU over an
   8-cell map: top-1 cells equal where the margin exceeds 1e-4, positions
   within 1e-2 m, tables equal where every retrieval agrees;
8. train: both trainers at the full width of the default Config (f32
   body) on a 96-pose synthetic map, batch 32: train_coarse for one epoch
   (3 steps) with a 32-pose validation split of the same cells, one
   retrieval eval and a checkpoint; train_fine (pad_size 16) for 2 epochs
   of 3 steps over PMC tables on the map's grid neighbours (pmc_prob 0.5),
   eval_fine every epoch, checkpoints; a third fine epoch resumed from the
   checkpoint directory. Step times, peak memory, losses, the evaluations,
   the PMC clones per batch, checkpoint save / restore ms and eval_fine ms,
   on a line with the card's name and power limit. Checks: losses finite,
   every parameter with a nonzero gradient changed (all three SA levels
   among them), BN running statistics moved, an eval in every epoch, some
   poses cloned, the resumed run trained only the third epoch and saved
   only past the restored best, the best checkpoint restored into a fresh
   model and optimizer equals what was saved bit for bit (model, Adam,
   schedule), eval_fine of the best weights on the card against the CPU
   (SA mode "first" on both, f32) per pose within 1e-2 m in normalized
   cell units (FINE_EVAL_LIMIT); fps, sa_train_fwd, sa_train_bwd,
   sa_select_first, mha_addln and ffn_addln launched;
9. train_vs_cpu: one coarse step (batch 8, dropout 0, no augmentation, f32)
   from the same seeded weights on the card and on the CPU: loss, every
   gradient leaf and the BN running statistics;
9b. dp: data parallelism (parallel/) at phase 8's shapes (f32 body, batch
   32, dropout and augmentation on, the training SA kernels): a coarse and
   a fine step from seeded weights (a) over a world of 1 rank on NCCL in
   this process and (b) over 2 spawned ranks on gloo, both on cuda:0, half
   the batch each, each against the same step without a mesh with phase
   9's limits (loss rel 1e-4; each gradient leaf rel-L2 1e-3 or cosine
   0.9999; BN running statistics rel 1e-4), sa_train_fwd and sa_train_bwd
   launched on every rank, and each leaf's norm within 1e-2 of the step's
   without a mesh (a leaf counted on every rank has a cosine of 1); (c) in
   the same 2 ranks, the sharded serve (f32, Config() width, phase 4's
   map) against the dense serve over 64 queries (top-1 equal where the
   margin exceeds 1e-4, positions within 1e-4 m); (d) in the same 2
   ranks, sa_train alone (the card's backward) at the coarse step's three
   levels on half the clouds each: statistics and the parameters'
   gradients summed over the ranks within rel-L2 1e-5 / 1e-3 of one
   rank's (one rank with its clouds rolled by half beside), and a control
   whose backward returns dgamma / dbeta reduced over the ranks (the
   double count) must fail that comparison; ms of a step per rank,
   launches and collectives per step, batch-8 ms of both serves, on a
   line with the card's name and power limit;
10. pipeline_optin: the opt-in kernel paths of the evaluation at full
   Config() width (bf16) over the 64-cell map and phase 6's weights:
   run_pipeline with fused_ln="all" and fused_ffn="0" (mode first), and
   with mode off, vmem_gather=True and fused_attn="0", with
   fused_attn="all", with fused_ffn="all", and with both (attn_ffn_all;
   each in mode first); wall seconds, fine_qps, top-1 agreement with the
   default run; add_ln, gather_rows and ffn_addln_tiled must launch (and
   launch 0 times in phases 4 and 6); then serve_optin, phase 4's serve
   with fused_ffn="all", whose build must launch ffn_addln_tiled;
11. pipeline_optin_vs_cpu: the same options in f32 on the card and on the
   CPU over an 8-cell map, with phase 7's criteria (fused_attn="all" runs
   the attention chain in f32 at E=1024, fused_ffn="all" the feed-forward
   chain, after stock attention or after the attention chain);
12. train_optin: 3 train_coarse steps with a bf16 body and the training SA
   tokens ("e","e","1") (e rounded to bf16), then 2 fine steps with
   ("0","0","e") and vmem_gather=True, at full width: step times and peak
   memory beside phase 8's f32 defaults; the checks of phase 8, and
   sa_train_e_fwd / sa_train_e_bwd / gather_rows / gather_rows_scatter
   launched;
13. train_optin_vs_cpu: one f32 coarse step with ("e","e","e"), card
   against CPU, with phase 9's criteria except the gradients: each leaf's
   cosine above 0.99 (ECACHE_GRAD_COS says why), and a control card step
   with ("e32","e32","e32") must fail that limit against the CPU's step;
14. serve_paths: serving a map of the published schema at Config() width
   (bf16), seeded random weights: a 16-cell, 48-pose scene pickled under
   the reference's module path with its compass neighbour map, converted
   by data/ingest.load_dataset into an npz cache, and converted again from
   the npz alone (no pickle read; every array equal); a Localizer with
   cache_path, then a second one from the file (no fps or sa_select_first
   launch, results bit-equal) and a file with another digest refused; the
   stepwise path (precompute_fine=False) at batches 1 and 8 against the
   cached serve (top-1 where the margin exceeds 1e-4, positions within
   1e-2 m), its queries launching fps, sa_select_first, mha_addln,
   mha_addln_tiled and ffn_addln; localize_embedded of the embedder's own
   token embeddings against localize (the same criteria) and
   localize_text of rendered descriptions equal to localize bit for bit;
   64 POSTs from 8 threads (hints and descriptions in turn) through
   LocalizationServer over a BatchingFrontend, each answer against the
   single-query localize (the same criteria), p50 / p99 and the mean group
   size; build seconds with and without the cache, the median ms a batch
   of each path and the phase's seconds, on a line with the card's name
   and power limit.
15. t5_text: the online T5 text path over phase 14's ingested scene: a
   T5-large encoder (the published widths of huggingface.co/t5-large:
   vocab 32128, d_model 1024, d_kv 64, 16 heads, d_ff 4096, ReLU, 24
   layers, 32 buckets, max distance 128; weights seeded with numpy at HF's
   initialisation scales; the vendored tiny tokenizer; T = 16) written as
   an HF snapshot (pytorch_model.bin, config.json, the tokenizer's files)
   and loaded by T5OnlineEncoder.from_snapshot on the card (write and load
   seconds); the same weights cut to 2 layers, card against CPU in f32
   over 48 styled sentences (TF32 off; largest absolute difference at most
   1e-3) and in bf16 (the snapshot loaded again with dtype "bfloat16"; at
   most T5_BF16_SPACINGS bf16 spacings at the largest |CPU output|) and, as
   the online encoder of f32 Localizers over the scene, localize_text of 8
   styled descriptions card against CPU (phase 5's criteria); the median ms
   of encode at 48 and 8 sentences, f32 and bf16 (24 layers), token
   positions a second and peak memory; localize_text of the 8 styled
   descriptions at Config() width (bf16) through the full encoder (median
   ms, top-1, launches a call; one T5 call a batch), and of 8 canonical
   descriptions bit-equal to localize with no T5 call; eval_styled_retrieval
   over the scene through the compositional stand-in and through T5
   (recall at k, seconds); on a line with the card's name and power limit.
16. readers_tables: (a) phase 15's encoder cut to its 2 card-vs-CPU layers,
   written as the hub cache holds a model id (refs/main, a snapshot of
   three safetensors shards and their index, the tied embedding kept once,
   a tokenizer.json in t5-large's layout: a Sequence of Precompiled, the
   charsmap of scripts/build_precompiled_charsmap.py, and Replace, then
   WhitespaceSplit and Metaspace) and loaded by that id through
   HF_HUB_CACHE, beside the same cut loaded from an unsharded directory
   with the vendored tokenizer: equal ids, and phase 15's 8 styled
   descriptions through localize_text at Config() width (bf16) give the
   same top-1 cells and positions within 1e-4 m (load seconds); (b)
   coarse and fine models with class_embed and color_embed, (c) with
   color_embed alone, f32 at Config() width over an 8-cell map: the
   cached, stepwise, embedded and text paths (the compositional online
   encoder, styled descriptions) and run_pipeline on the card and on the
   CPU, by phases 5 and 7's criteria, and each path's launches on the
   card: no fps or SA kernel with the class table (no PointNet), fps and
   sa_select_first with the colour table alone, mha_addln and ffn_addln
   in both.
17. prep_serve: from a raw KITTI-360 scene to a served map inside the
   port. A synthetic drive in KITTI-360's raw layout, written with numpy
   from a seed (data_3d_semantics/<scene>/static/*.ply with x, y, z, rgb,
   semantic and instance; data_poses/<scene>/poses.txt): 4 static windows
   of 1,050,000 points over a 400 m trajectory (a pose a metre), road,
   sidewalk, terrain and trees along all of it, buildings and poles (and
   cars, which no class takes) along it. The port's prep CLI
   (prep/prepare.py) on the card at its defaults (cell_size 30, cell_dist
   10, pose_dist 10, pose_count 4, num_mentioned 6, describe_by all, seed
   4096, --array_dir): the seconds of gather_objects, cells, poses and
   ingest, and the counts of windows, points, objects, cells and poses. On
   a cut of one window, the card's prep against the CPU's: the objects,
   cells, poses, direction JSON and npz arrays equal, the CPU's seconds
   beside the card's. Then the full scene's arrays served at Config()
   width (bf16, seeded weights): build seconds, a batch of 8 requests
   (checked as phase 4 checks them, median ms), the launches of fps,
   sa_select_first, mha_addln, mha_addln_tiled and ffn_addln (each > 0,
   no opt-in kernel); and the f32 serve of the same 8 requests on the card
   against the CPU over the same map, by phase 5's criteria; on a line
   with the card's name and power limit.

Phase 3 also holds the opt-in kernels against their plain versions: add_ln
at the E=1024 trunk's rows and at D=128/256 (bf16, f32), each line with
kernel_ms and its plan (rows a warp, warps a row, chunks a lane, blocks,
blocks an SM), and, not summed, at the trunk's rows at D=384 and 768
(bf16, f32), at 6,336 rows at D=2048 (f32) and 4096 (bf16), and at the row
routine's limits, 8192 (f32) and 16384 (bf16); a width past the limit
must raise ValueError before any launch; gather_rows at the
gallery's three mode-off shapes (bf16, f32) and at the gather probe's
shapes (f32), each line with kernel_ms and its plan (copy word, chunk
bytes, chunks a cloud; the fps line with kernel_ms and its points a lane),
gather_rows_scatter at the probe's shapes (f32, 896 clouds),
and the training level of the token "e" (sa_train_e_fwd / _bwd) at the coarse
step's three levels (f32, bf16), with the time of one PyTorch call that
computes the same function where there is one (library_ms).

Then the kernels line (launches: the counts during phases 4, 4b, 5b, 6, 8, 9b
(every rank), 10 (serve_optin too), 12, 14, 15, 16 and 17, each path's counts set
to 0 just before it;
max_abs_err, ms, plain_ms, bound_ms and library_ms: over the inference
kernels' bf16 cases of phase 3 (sa_gather's approximate ball query cases),
FPS's f32 case, the training kernels' f32 cases, the "e" kernels' bf16
cases, the scatter's f32 cases and tf32_split's two intra cases, the
paths' dtypes; tf32_split launches in phase 5b's f32 layers), the card's
nvidia-smi line and, last, the result line. Any failed check raises: the
script exits non-zero and prints no result. It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
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


def kernel_ms(fn, reps: int = 10, launches: int = 50) -> float:
    """Median milliseconds of one fn() on the card with the host's dispatch
    off the measured span: `launches` calls queued behind a device sleep,
    between two CUDA events, divided by `launches`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)          # about 20 ms: the host queues every launch
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
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
# bf16 tensor cores, HBM bandwidth. F32_TC_FLOPS: f32 products as 3xTF32 on
# the tensor cores (three TF32 products at 495 TFLOP/s each), the peak of
# every f32 line whose products run so: the tiled chains' (their products
# and their attention core), the fused attention and feed-forward blocks'
# and the SA tile kernel's in every selection, and the training SA
# level's, forward and backward, recompute and "e" (Mma<float>,
# csrc/sa_train_tiles.cuh). FPS, which has no product, keeps the FP32 peak.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
F32_TC_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12


def _sa_peak(dt):
    """The SA kernels' peak (inference tiles and the training level): their
    f32 products run 3xTF32."""
    return F32_TC_FLOPS if dt == torch.float32 else None


def bound(flops: float, nbytes: float, dtype, peak=None):
    """(op seconds, byte seconds): the least time of the work on the card
    is the larger of the two; `peak` in place of PEAK_FLOPS[dtype]."""
    return flops / (peak or PEAK_FLOPS[dtype]), nbytes / HBM_BYTES_PER_S


class KernelRecord:
    """Errors, times and bounds of one kernel over its main-path cases."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.max_ulps = None      # bf16 add_ln: the error in units of the bf16 spacing
        self.ms = 0.0
        self.plain_ms = 0.0
        self.bound_ms = 0.0
        self.library_ms = None
        self.op_s = 0.0
        self.byte_s = 0.0
        self.last_line = None     # the last case line emitted

    @property
    def bound_by(self) -> str:
        return "operations" if self.op_s >= self.byte_s else "bytes"

    def add(self, name, dtype, pairs, kernel_fn, plain_fn, work, exact=False,
            norm_floor=None, counts=None, limit_fn=None, library_fn=None, yardsticks=None,
            info=None):
        """pairs: [(kernel output, plain output)], each within TOLERANCE x
        max|plain| (0 when exact); work: (FLOPs, bytes, dtype of the products
        [, peak FLOP/s in place of the dtype's]) of the case. With
        `norm_floor` the check is instead ||kernel - plain||
        <= REL_L2[dtype] x max(||plain||, norm_floor) per pair; with
        `limit_fn(got, want)` -> (max abs error, limit, ok, ulps) the check
        is the case's own (ulps: the error in bf16 spacings, or None).
        `library_fn`: one PyTorch call computing the same function, timed
        beside the kernel; `yardsticks`: {key: fn} timed onto the case line
        only (stock_ms: the port's stock-ops path for the same function);
        `info`: further keys of the case line. Returns the case's (ms, plain_ms)."""
        err, ok, limit, rels, ulps = 0.0, True, 0.0, [], None
        for got, want in pairs:
            got, want = got.float(), want.float()
            e = (got - want).abs().max().item() if got.numel() else 0.0
            peak = want.abs().max().item() if want.numel() else 0.0
            lim = 0.0 if exact else TOLERANCE[dtype] * peak
            if limit_fn is not None:
                e, lim, good, u = limit_fn(got, want)
                if u is not None:
                    ulps = max(ulps or 0.0, u)
            elif norm_floor is None:
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
        library_ms = cuda_ms(library_fn) if library_fn is not None else None
        extra = {key: cuda_ms(fn) for key, fn in (yardsticks or {}).items()}
        op_s, byte_s = bound(*work)
        bound_ms = max(op_s, byte_s) * 1e3
        self.last_line = {
            "phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "bound": limit, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if op_s >= byte_s else "bytes",
            "library_ms": library_ms, **extra, **(info or {}), "ok": ok,
            **({"rel_l2_errs": rels} if norm_floor is not None else {}),
            **({"max_ulps": ulps} if ulps is not None else {})}
        emit(self.last_line)
        check(ok, f"{name} {dtype}: error {err} above {limit}")
        if counts if counts is not None else (dtype == torch.bfloat16 or exact):
            self.max_abs_err = max(self.max_abs_err, err)
            if ulps is not None:
                self.max_ulps = max(self.max_ulps or 0.0, ulps)
            self.ms += ms
            self.plain_ms += plain_ms
            self.bound_ms += bound_ms
            if library_ms is not None:
                self.library_ms = (self.library_ms or 0.0) + library_ms
            self.op_s += op_s
            self.byte_s += byte_s
        return ms, plain_ms


SA_LEVELS = [(256, 128, 6, 32, 64, 0.2), (128, 64, 67, 128, 128, 0.3),
             (64, 32, 131, 256, 256, 0.4)]   # P, S, C+3, H1, H2, radius of Config()


def phase_sa_kernels(dev, gen, pts, xyz, records) -> None:
    """The inference SA kernel in each selection against its plain version
    at the gallery's three levels (1792 clouds, K=32), bf16 and f32: first
    and bisect (fused_sa_select), gather over the exact and the approximate
    ball query (fused_sa_gather), exact and all (fused_set_abstraction),
    each line with its plan on the tile kernel. Then
    "all" at SA1 with a dense cluster (3/4 of each cloud's points within
    0.01 of its first center), whose centers there hold more edges than the
    plan's tile: a line of its own, not summed. The plain all/exact
    versions run in chunks of clouds. Bound: the products (u = feat @ W1
    per point, the center term, the second layer over this data's selected
    edges) and each input and output once."""
    from text2loc_tpu_torch.ops import cuda_pointconv as cp
    from text2loc_tpu_torch.ops import pointconv as pc
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn, first_k, squared_distances

    n, k = pts.shape[0], 32
    for dt in (torch.bfloat16, torch.float32):
        pos = pts
        for lp, s, cin, h1, h2, radius in SA_LEVELS:
            ctr = xyz[:, :s].contiguous()
            x = _rand(gen, (n, lp, cin - 3), 1.0, dev).to(dt).contiguous()
            feat = torch.cat([x, pos.to(dt)], -1).contiguous()
            w1 = _rand(gen, (cin, h1), cin ** -0.5, dev).to(dt)
            w2 = _rand(gen, (h1, h2), h1 ** -0.5, dev).to(dt)
            wx, wp = w1[:cin - 3].contiguous(), w1[cin - 3:].contiguous()
            ab1 = torch.stack([_rand(gen, h1, 0.1, dev, 1.0), _rand(gen, h1, 0.1, dev)])
            ab2 = torch.stack([_rand(gen, h2, 0.1, dev, 1.0), _rand(gen, h2, 0.1, dev)])
            ab1, ab2 = ab1.contiguous(), ab2.contiguous()
            es = feat.element_size()
            d2, r2 = squared_distances(pos, ctr), radius * radius
            inr = d2 <= r2
            edges = {"first": ball_query_knn(pos, ctr, radius, k, first=True)[1],
                     "bisect": first_k(pc.bisect_mask(d2, inr, r2, k, 12), k)[1],
                     "exact": inr.sum(-1).clamp(max=k), "all": inr}
            edges = {key: int(v.sum().item()) for key, v in edges.items()}
            fixed = n * s * (12 + h2 * es) + (cin * h1 + h1 * h2) * es + 8 * (h1 + h2)

            def work(e, nbytes, h1=h1, h2=h2, lp=lp, cin=cin, s=s):
                return (2.0 * (n * lp * cin * h1 + n * s * 3 * h1 + e * h1 * h2), nbytes, dt,
                        _sa_peak(dt))

            tag = f"P={lp} S={s} {cin}->{h1}->{h2}"
            args = (feat, pos, ctr, w1, wp, ab1, w2, ab2, radius, k)
            for sel, name in (("first", "sa_select_first"), ("bisect", "sa_select_bisect")):
                e = edges[sel]
                records[name].add(
                    f"{name} {tag} edges={e}", dt,
                    [(cp.sa_select_cuda(*args, selection=sel),
                      pc.sa_select_plain(*args, selection=sel))],
                    lambda a=args, sel=sel: cp.sa_select_cuda(*a, selection=sel),
                    lambda a=args, sel=sel: pc.sa_select_plain(*a, selection=sel),
                    work(e, n * lp * (cin * es + 12) + fixed),
                    info={"plan": cp.tile_plan(lp, s, cin, h1, h2, k, dt, sel)._asdict()})
            for approx in (False, True):
                idx, mask = ball_query_knn(pos, ctr, radius, k, approx=approx)
                gargs = (feat, ctr, idx.to(torch.int32).contiguous(), mask.contiguous(),
                         w1, wp, ab1, w2, ab2)
                e = int(mask.sum().item())
                # The record sums the approximate case: the gather mode's default.
                records["sa_gather"].add(
                    f"sa_gather {'approx' if approx else 'exact'} {tag} edges={e}", dt,
                    [(cp.sa_gather_cuda(*gargs), pc.sa_gather_plain(*gargs))],
                    lambda a=gargs: cp.sa_gather_cuda(*a),
                    lambda a=gargs: pc.sa_gather_plain(*a),
                    work(e, n * lp * cin * es + n * s * k * 5 + fixed),
                    counts=approx and dt == torch.bfloat16,
                    info={"plan": cp.tile_plan(lp, s, cin, h1, h2, k, dt,
                                               "gather")._asdict()})
            sargs = (x, pos, ctr, wx, wp, ab1, w2, ab2, radius, k)
            all_plan = cp.tile_plan(lp, s, cin - 3, h1, h2, k, dt, "all")
            for select_k, name in ((True, "sa_exact"), (False, "sa_all")):
                e = edges["exact" if select_k else "all"]
                records[name].add(
                    f"{name} {tag} edges={e}", dt,
                    [(cp.set_abstraction_cuda(*sargs, select_k=select_k),
                      pc.set_abstraction_plain(*sargs, select_k=select_k))],
                    lambda a=sargs, sk=select_k: cp.set_abstraction_cuda(*a, select_k=sk),
                    lambda a=sargs, sk=select_k: pc.set_abstraction_plain(*a, select_k=sk),
                    work(e, n * lp * ((cin - 3) * es + 12) + fixed),
                    info={"plan": cp.tile_plan(lp, s, cin - 3, h1, h2, k, dt,
                                               "exact")._asdict()}
                    if select_k else {"plan": all_plan._asdict(), **_all_tiles(inr, all_plan)})
            if lp == SA_LEVELS[0][0]:
                # A dense cluster: centers with more edges than the tile.
                dense = pos.clone()
                q = 3 * lp // 4
                noise = torch.rand((n, q - 1, 3), generator=torch.Generator().manual_seed(SEED))
                dense[:, 1:q] = dense[:, :1] + 0.01 * (noise - 0.5).to(dev)
                dinr = squared_distances(dense, ctr) <= r2
                over = int((dinr.sum(-1) > all_plan.rows).sum().item())
                check(over > 0, f"sa_all dense cluster {dt}: no center above the tile")
                dargs = (x, dense, ctr, wx, wp, ab1, w2, ab2, radius, k)
                e = int(dinr.sum().item())
                records["sa_all"].add(
                    f"sa_all dense cluster {tag} edges={e}", dt,
                    [(cp.set_abstraction_cuda(*dargs, select_k=False),
                      pc.set_abstraction_plain(*dargs, select_k=False))],
                    lambda a=dargs: cp.set_abstraction_cuda(*a, select_k=False),
                    lambda a=dargs: pc.set_abstraction_plain(*a, select_k=False),
                    work(e, n * lp * ((cin - 3) * es + 12) + fixed), counts=False,
                    info={"plan": all_plan._asdict(), "centers_above_tile": over,
                          **_all_tiles(dinr, all_plan)})
            pos = ctr


def _all_tiles(inr, plan) -> dict:
    """The "all" kernel's groups and tiles over in-radius masks inr [N, S,
    P] as it cuts them (cuda_pointconv.all_groups, tiles of plan.rows rows
    a group), and the tiles' mean filled rows."""
    from text2loc_tpu_torch.ops import cuda_pointconv as cp

    groups = tiles = rows = 0
    for counts in inr.sum(-1).cpu().tolist():
        for g0, g1 in cp.all_groups(counts, plan.budget):
            r = sum(counts[g0:g1])
            groups += 1
            tiles += -(-r // plan.rows)
            rows += r
    return {"groups": groups, "tiles": tiles, "mean_tile_rows": rows / max(tiles, 1)}


SA_KERNELS = ("sa_select_first", "sa_select_bisect", "sa_gather", "sa_exact", "sa_all")


def _stock_attention_fn(args, dt, heads=4):
    """The port's fused_attn="0" block (models/transformer.py: stock
    projections and attention, cuBLAS products, then the stock add +
    LayerNorm) with the case's weights: a yardstick the port's fused route
    never calls."""
    from text2loc_tpu_torch.models.transformer import (Dropout, Gates,
                                                       MultiheadAttentionParams,
                                                       attention_block)

    x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = args
    d = x.shape[-1]
    params = MultiheadAttentionParams(d, heads).to(x.device)
    norm = torch.nn.LayerNorm(d).to(x.device)
    with torch.no_grad():
        for proj, w, b in zip((params.query, params.key, params.value, params.out),
                              (wq, wk, wv, wo), (bq, bk, bv, bo)):
            proj.weight.copy_(w)
            proj.bias.copy_(b)
        norm.weight.copy_(g)
        norm.bias.copy_(be)
    drop = Dropout(0.0).eval()

    def run():
        with torch.no_grad():
            return attention_block(x, kv, mask, params, norm, dt, drop, Gates(attn="0"))
    return run


def _fused_attention_fn(args):
    """The fused attention kernel alone (cuda_mha.launch_fused, no count):
    what `kernel_ms` times beside the wrapper's `ms`."""
    from text2loc_tpu_torch.ops import cuda_mha

    x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = args
    out = torch.empty_like(x)
    return lambda: cuda_mha.launch_fused(x, kv, (wq, wk, wv, wo), (bq, bk, bv, bo, g, be),
                                         mask, out, num_heads=4, count=False)


def _attention_args(gen, dev, dt, b, lq, lk, d, self_attn, empty):
    """One attention case's inputs: activations in dt, f32 weights (as the
    model holds its parameters), a bool key mask with a quarter padded."""
    x = _rand(gen, (b, lq, d), 1.0, dev).to(dt)
    kv = x if self_attn else _rand(gen, (b, lk, d), 1.0, dev).to(dt)
    mats = [_rand(gen, (d, d), d ** -0.5, dev) for _ in range(4)]
    vecs = [_rand(gen, d, 0.1, dev) for _ in range(4)]
    mask = torch.rand(b, lk, generator=gen).to(dev) > 0.25
    mask[:, 0] = True
    if empty:
        mask[0] = False   # attends uniformly over its own keys
    return (x, kv, mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2],
            mats[3], vecs[3], _rand(gen, d, 0.1, dev, 1.0), _rand(gen, d, 0.1, dev), mask)


def _stage_checks(kname, name, dt, stages, info=None) -> None:
    """Each stage of a tiled chain alone against its plain stage on the
    plain stage's inputs (TOLERANCE x max|plain|), with its time. stages:
    [(stage, fn returning a tuple of outputs, the plain outputs[, one
    PyTorch call computing the stage, timed as library_ms])]; info: further
    keys of every stage line."""
    for stage, fn, wants, *library in stages:
        err, ok, limit = 0.0, True, 0.0
        for got, want in zip(fn(), wants):
            got, want = got.float(), want.float()
            e = (got - want).abs().max().item()
            lim = TOLERANCE[dt] * want.abs().max().item()
            ok = ok and bool(torch.isfinite(got).all()) and e <= lim
            if e >= err:
                err, limit = e, lim
        emit({"phase": "kernel_stage", "case": f"{kname} {name}", "stage": stage,
              "dtype": str(dt).split(".")[-1], "max_abs_err": err, "bound": limit,
              "ms": cuda_ms(fn), **({"library_ms": cuda_ms(library[0])} if library else {}),
              **(info or {}), "ok": ok})
        check(ok, f"{kname} {name} stage {stage}: error {err} above {limit}")


def _core_plan_info(lq, lk, d, dt, heads=4) -> dict:
    """The tiled chain's attention-core plan at this shape."""
    from text2loc_tpu_torch.ops import cuda_mha

    plan = cuda_mha.core_layout(lq, lk, d, heads, dt)
    return {"core_rows": plan.rows, "core_chunk": plan.chunk, "core_sweeps": plan.sweeps}


def _library_project_fn(args):
    """One PyTorch call per product for stage (a), the port never makes
    it: torch.addmm over the packed [Wq|Wk|Wv] (self-attention), or x Wq
    and kv [Wk|Wv] (cross), weights and biases packed and cast beforehand."""
    x, kv, wq, bq, wk, bk, wv, bv = args[:8]
    dt = x.dtype
    d = x.shape[-1]
    x2, kv2 = x.reshape(-1, d), kv.reshape(-1, d)
    if kv is x:
        w = torch.cat([wq, wk, wv], dim=1).to(dt)
        b = torch.cat([bq, bk, bv]).to(dt)
        return lambda: torch.addmm(b, x2, w)
    wkv, bkv = torch.cat([wk, wv], dim=1).to(dt), torch.cat([bk, bv]).to(dt)
    wq_, bq_ = wq.to(dt), bq.to(dt)
    return lambda: (torch.addmm(bq_, x2, wq_), torch.addmm(bkv, kv2, wkv))


def _library_core_fn(q, k, v, mask):
    """F.scaled_dot_product_attention over the projected heads with the
    additive key bias (q is pre-scaled: scale 1), the port never calls it."""
    from text2loc_tpu_torch.ops import mha

    b, lq, d = q.shape
    lk = k.shape[1]
    heads = lambda t, n: t.reshape(b, n, 4, d // 4).transpose(1, 2)
    qh, kh, vh = heads(q, lq), heads(k, lk), heads(v, lk)
    bias = mha.key_bias(mask, b, lk, q.device)[:, None, None, :].to(q.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=bias, scale=1.0)


def _split_case(record, kname, name, mats, counts):
    """The weights' transposed TF32 split (cuda_split.split_t_cuda, its
    kernel alone) of a tiled chain's f32 case: bit for bit its
    plain version on the card, with its time and kernel_ms beside its bound
    (bytes: each weight read once, hi and lo written once). Returns the
    kernel's (hi, lo) for the chain's stages."""
    from text2loc_tpu_torch.ops import cuda_split

    def fn():
        return cuda_split.split_t_cuda(mats)

    got, want = fn(), cuda_split.split_t_plain(mats)
    check(all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)),
          f"tf32_split {kname} {name}: not bit-equal to its plain version")
    shapes = " ".join(f"{k}x{n}" for k, n in (w.shape for w in mats))
    record.add(f"tf32_split {kname} {name} {shapes}", torch.float32, list(zip(got, want)), fn,
               lambda: cuda_split.split_t_plain(mats),
               (0.0, 12.0 * sum(w.numel() for w in mats), torch.float32), exact=True,
               counts=counts, info={"kernel_ms": kernel_ms(fn)})
    return got


def _tf32_control(kname, name, plain_fn) -> None:
    """The control of the f32 limit: the chain's products on TF32 alone (the
    plain stage with torch.backends.cuda.matmul.allow_tf32 on for this line
    only, then off again) against the same stage in full f32 must miss
    TOLERANCE[torch.float32], so that the limit tells 3xTF32 from TF32
    alone."""
    want = plain_fn()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = plain_fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio, err, limit = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        e = (g.float() - w.float()).abs().max().item()
        lim = TOLERANCE[torch.float32] * w.float().abs().max().item()
        if e / lim >= ratio:
            ratio, err, limit = e / lim, e, lim
    emit({"phase": "kernel_control", "case": f"{kname} {name}: products on TF32 alone",
          "dtype": "float32", "max_abs_err": err, "bound": limit, "misses": ratio > 1.0})
    check(ratio > 1.0, f"{kname} {name}: the products on TF32 alone ({err}) within the f32 "
          f"limit ({limit}): the limit cannot tell them from 3xTF32")


def _mha_tiled_stages(name, args, dt, split_record, counts=False) -> None:
    """The attention chain's stages: in f32 first the split of the four
    weights (_split_case, a kernel line of tf32_split, summed where
    `counts`), then on it (a) the projection product(s), (b) the attention
    core, (c)+(d) the out-projection with the residual and the LayerNorm;
    the core's plan on every line, library_ms on (a) and (b)."""
    from text2loc_tpu_torch.ops import cuda_mha, mha

    x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, be, mask = args
    proj = out = None
    if dt == torch.float32:
        hi, lo = _split_case(split_record, "mha_addln_tiled", name, [wq, wk, wv, wo], counts)
        n3 = 3 * wq.numel()
        proj, out = (hi[:n3], lo[:n3]), (hi[n3:], lo[n3:])
    q, k, v = mha.mha_project_plain(x, kv, wq, bq, wk, bk, wv, bv, num_heads=4)
    o = mha.mha_core_plain(q, k, v, mask, num_heads=4)
    _stage_checks("mha_addln_tiled", name, dt, [
        ("project", lambda: cuda_mha.tiled_project_cuda(x, kv, wq, bq, wk, bk, wv, bv,
                                                        num_heads=4, split=proj), (q, k, v),
         _library_project_fn(args)),
        ("core", lambda: (cuda_mha.tiled_core_cuda(q, k, v, mask, num_heads=4),), (o,),
         _library_core_fn(q, k, v, mask)),
        ("out_addln", lambda: (cuda_mha.tiled_out_addln_cuda(x, o, wo, bo, g, be, split=out),),
         (mha.mha_out_addln_plain(x, o, wo, bo, g, be),)),
    ], info=_core_plan_info(x.shape[1], kv.shape[1], x.shape[2], dt))


def _stock_ffn_fn(args, dt):
    """The port's fused_ffn="0" block (models/transformer.py: stock
    products with cuBLAS, relu, then the stock add + LayerNorm) with the
    case's weights: a yardstick the port's fused route never calls."""
    from text2loc_tpu_torch.models.transformer import Dropout, Gates, Projection, feed_forward

    x, w1, b1, w2, b2, g, be = args
    d, f = w1.shape
    lin1, lin2 = Projection(d, f).to(x.device), Projection(f, d).to(x.device)
    norm = torch.nn.LayerNorm(d).to(x.device)
    with torch.no_grad():
        for p, v in ((lin1.weight, w1), (lin1.bias, b1), (lin2.weight, w2), (lin2.bias, b2),
                     (norm.weight, g), (norm.bias, be)):
            p.copy_(v)
    drop = Dropout(0.0).eval()

    def run():
        with torch.no_grad():
            return feed_forward(x, lin1, lin2, norm, dt, drop, Gates(ffn="0"))
    return run


def _ffn_args(gen, dev, dt, rows, d, f):
    """One feed-forward case's inputs: activations in dt, f32 weights and
    vectors (as the model holds its parameters)."""
    return (_rand(gen, (rows, d), 1.0, dev).to(dt),
            _rand(gen, (d, f), d ** -0.5, dev), _rand(gen, f, 0.1, dev),
            _rand(gen, (f, d), f ** -0.5, dev), _rand(gen, d, 0.1, dev),
            _rand(gen, d, 0.1, dev, 1.0), _rand(gen, d, 0.1, dev))


def _fused_ffn_fn(args):
    """The fused feed-forward kernel alone (cuda_ffn.fused_block_cuda into a
    preallocated output, no count): what `kernel_ms` times beside the
    wrapper's `ms`."""
    from text2loc_tpu_torch.ops import cuda_ffn

    out = torch.empty_like(args[0])
    return lambda: cuda_ffn.fused_block_cuda(*args, out=out, count=False)


def _ffn_tiled_stages(name, args, dt, split_record, counts=False) -> None:
    """The feed-forward chain's stages, through its own stage entries (the
    functions the block runs): in f32 first the split of W1 and W2
    (_split_case, a kernel line of tf32_split, summed where `counts`), then
    on it (a) the hidden product with the relu epilogue, (b)+(c) the
    residual product (K = F) and the LayerNorm."""
    from text2loc_tpu_torch.ops import cuda_ffn, ffn

    x, w1, b1, w2, b2, g, be = args
    s1 = s2 = None
    if dt == torch.float32:
        hi, lo = _split_case(split_record, "ffn_addln_tiled", name, [w1, w2], counts)
        n1 = w1.numel()
        s1, s2 = (hi[:n1], lo[:n1]), (hi[n1:], lo[n1:])
    h = ffn.ffn_hidden_plain(x, w1, b1)
    _stage_checks("ffn_addln_tiled", name, dt, [
        ("hidden", lambda: (cuda_ffn.tiled_hidden_cuda(x, w1, b1, split=s1),), (h,)),
        ("out_addln", lambda: (cuda_ffn.tiled_out_addln_cuda(x, h, w2, b2, g, be, split=s2),),
         (ffn.ffn_out_addln_plain(h, x, w2, b2, g, be),)),
    ])


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version at the shapes of a 64-cell gallery
    (1792 clouds of 256 points) and a 64-query batch with top-10."""
    from text2loc_tpu_torch.ops import cuda_ffn, cuda_fps, cuda_mha, ffn, fps, mha

    gen = torch.Generator().manual_seed(SEED)
    records = {k: KernelRecord() for k in ("fps", *SA_KERNELS, "mha_addln", "mha_addln_tiled",
                                          "ffn_addln", "ffn_addln_tiled", "tf32_split")}

    n, p = 64 * 28, 256
    pts = _clouds(gen, n, p, dev)
    idx, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    want_idx, want_xyz = fps.farthest_point_sampling_plain(pts, 128)
    check(torch.equal(idx, want_idx), "fps: indices differ from the plain version")
    # 3 subtractions, 3 products and 2 sums per point and round.
    def fps_fn():
        return cuda_fps.farthest_point_sampling_cuda(pts, 128)

    records["fps"].add("fps 1792x256->128", torch.float32, [(xyz, want_xyz)], fps_fn,
                       lambda: fps.farthest_point_sampling_plain(pts, 128),
                       (8.0 * n * 127 * p, n * p * 12 + n * 128 * 16, torch.float32),
                       exact=True, info={"kernel_ms": kernel_ms(fps_fn),
                                         "per_lane": cuda_fps.fps_plan(p, 128).per_lane})
    phase_sa_kernels(dev, gen, pts, xyz, records)

    # (name, B, Lq, Lk, D, self-attention, one sample with every key masked)
    attn_cases = [("cct obj cross", 640, 16, 6, 128, False, False),
                  ("cct hint cross", 640, 6, 16, 128, False, False),
                  ("cct obj self", 640, 16, 16, 128, True, False),
                  ("cct hint self", 64, 6, 6, 128, True, True),
                  ("obj_inter", 64, 28, 28, 256, True, False),
                  ("inter head", 64, 6, 6, 256, True, False),
                  ("intra E=1024", 1584, 16, 16, 1024, True, False)]
    # A batch-1 serve request's blocks (the coarse inter head and the layer-0
    # hint block at B=1, the CCT over the top-10 cells at B=10): case lines
    # of their own, not summed into the kernel's record, with inputs from a
    # generator of their own (the other cases keep theirs).
    gen_request = torch.Generator().manual_seed(SEED + 1)
    request_cases = [("request inter head", 1, 6, 6, 256, True, False),
                     ("request hint pre", 1, 6, 6, 128, True, False),
                     ("request obj cross", 10, 16, 6, 128, False, False),
                     ("request hint cross", 10, 6, 16, 128, False, False),
                     ("request obj self", 10, 16, 16, 128, True, False),
                     ("request hint self", 10, 6, 6, 128, True, False)]
    # Lengths past the attention core's one-sweep chunk (64 keys) at E=1024:
    # its two sweeps. No Config() shape reaches them; lines of their own, not
    # summed, each with one sample whose keys are all masked.
    gen_long = torch.Generator().manual_seed(SEED + 10)
    long_cases = [("long self", 16, 128, 128, 1024, True, True),
                  ("long cross", 16, 16, 600, 1024, False, True)]
    for dt in (torch.bfloat16, torch.float32):
        for (name, b, lq, lk, d, self_attn, empty), g in (
                [(c, gen) for c in attn_cases] + [(c, gen_request) for c in request_cases]
                + [(c, gen_long) for c in long_cases]):
            args = _attention_args(g, dev, dt, b, lq, lk, d, self_attn, empty)
            es = args[0].element_size()
            kname = ("mha_addln" if cuda_mha.route(lq, lk, d, 4, dt, self_attn=self_attn)
                     == "fused" else "mha_addln_tiled")
            fused = kname == "mha_addln"
            tiled = not fused
            long = name.startswith("long")
            f32_tc = dt == torch.float32     # 3xTF32 products on either route
            work = (2.0 * (2 * b * lq * d * d + 2 * b * lk * d * d + 2 * b * lq * lk * d),
                    2 * b * lq * d * es + (0 if self_attn else b * lk * d * es)
                    + 4 * d * d * 4 + 6 * d * 4 + b * lk, dt, F32_TC_FLOPS if f32_tc else None)
            # The fused lines: kernel_ms (the kernel alone, no host dispatch)
            # and stock_ms; the tiled chain's lines: stock_ms.
            ms, plain_ms = records[kname].add(
                f"{kname} {name} B={b} Lq={lq} Lk={lk} D={d}", dt,
                [(cuda_mha.mha_addln_cuda(*args, num_heads=4),
                  mha.mha_addln_plain(*args, num_heads=4))],
                lambda a=args: cuda_mha.mha_addln_cuda(*a, num_heads=4),
                lambda a=args: mha.mha_addln_plain(*a, num_heads=4), work,
                counts=False if name.startswith(("request", "long")) else None,
                yardsticks={"stock_ms": _stock_attention_fn(args, dt)},
                info=({"kernel_ms": kernel_ms(_fused_attention_fn(args))} if fused
                      else _core_plan_info(lq, lk, d, dt)))
            if tiled and not long:
                stock_ms = records[kname].last_line["stock_ms"]
                check(ms < plain_ms and ms <= stock_ms and (f32_tc or ms <= 3.0),
                      f"{kname} {name}: {ms} ms, plain {plain_ms} ms, stock {stock_ms} ms "
                      "(limit: faster than plain, no slower than stock, in bf16 at most 3 ms)")
                _mha_tiled_stages(name, args, dt, records["tf32_split"], counts=True)
                if f32_tc:
                    _tf32_control(kname, name, lambda a=args: mha.mha_project_plain(
                        *a[:8], num_heads=4))
            if long:
                check(cuda_mha.core_layout(lq, lk, d, 4, dt).sweeps == 2,
                      f"{name}: the core's two sweeps")
                check(ms < plain_ms, f"{kname} {name}: {ms} ms, plain {plain_ms} ms "
                      "(limit: faster than plain)")
                _mha_tiled_stages(name, args, dt, records["tf32_split"])

    ffn_cases = [("cct", 640 * 16, 128, 512), ("obj_inter", 64 * 28, 256, 512),
                 ("inter head", 64 * 6, 256, 1024), ("intra E=1024", 1584 * 16, 1024, 4096)]
    # A batch-1 serve request's blocks (the coarse inter head over 6 rows, the
    # CCT's hint and object layers over the top-10 cells): case lines of their
    # own, not summed, with inputs from a generator of their own.
    gen_ffn_request = torch.Generator().manual_seed(SEED + 2)
    ffn_request_cases = [("request inter head", 6, 256, 1024),
                         ("request cct hint", 60, 128, 512),
                         ("request cct obj", 160, 128, 512)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        for (name, rows, d, f), g in ([(c, gen) for c in ffn_cases]
                                      + [(c, gen_ffn_request) for c in ffn_request_cases]):
            args = _ffn_args(g, dev, dt, rows, d, f)
            es = args[0].element_size()
            kname = "ffn_addln" if cuda_ffn.route(d, f, dt) == "fused" else "ffn_addln_tiled"
            fused = kname == "ffn_addln"
            tiled = not fused
            f32_tc = dt == torch.float32     # 3xTF32 products on either route
            work = (4.0 * rows * d * f, 2 * rows * d * es + 2 * d * f * 4 + (f + 3 * d) * 4,
                    dt, F32_TC_FLOPS if f32_tc else None)
            # Every line: stock_ms, the port's stock block; the fused lines:
            # kernel_ms (the kernel alone, no host dispatch) and the plan.
            info = None
            if fused:
                plan = cuda_ffn.fused_plan(rows, d, f, dt, sms=sms)
                info = {"kernel_ms": kernel_ms(_fused_ffn_fn(args)),
                        "tile_rows": plan.rows, "cluster": plan.cluster, "blocks": plan.blocks}
            ms, plain_ms = records[kname].add(
                f"{kname} {name} R={rows} D={d} F={f}", dt,
                [(cuda_ffn.ffn_addln_cuda(*args), ffn.ffn_addln_plain(*args))],
                lambda a=args: cuda_ffn.ffn_addln_cuda(*a),
                lambda a=args: ffn.ffn_addln_plain(*a), work,
                counts=False if name.startswith("request") else None,
                yardsticks={"stock_ms": _stock_ffn_fn(args, dt)}, info=info)
            if tiled:
                stock_ms = records[kname].last_line["stock_ms"]
                check(ms < plain_ms and ms <= stock_ms,
                      f"{kname} {name}: {ms} ms, plain {plain_ms} ms, stock {stock_ms} ms "
                      "(limit: faster than plain, no slower than stock)")
                _ffn_tiled_stages(name, args, dt, records["tf32_split"], counts=True)
                if f32_tc:
                    _tf32_control(kname, name, lambda a=args: (ffn.ffn_hidden_plain(*a[:3]),))
    _wide_chains(dev, records)
    torch.cuda.synchronize()
    return records


# Both tiled chains at rows wider than one warp's LayerNorm (the row
# routine's wide layout, two warps a row): D=2048 in f32 and 4096 in bf16,
# 16 heads, F = 4D, a few hundred rows (at R=384 the f32 residual product
# has 48 output tiles for 132 SMs). No Config() shape reaches them: lines
# of their own, not summed, with stock_ms; the f32 lines faster than plain,
# with the weights' split alone on a line of its own.
WIDE_ATTN = [("wide self", 24, 16, 16, 2048, True, torch.float32),
             ("wide self", 24, 16, 16, 4096, True, torch.bfloat16)]
WIDE_FFN = [("wide", 384, 2048, 8192, torch.float32),
            ("wide", 384, 4096, 16384, torch.bfloat16)]
WIDE_HEADS = 16


def _wide_chains(dev, records) -> None:
    from text2loc_tpu_torch.ops import cuda_ffn, cuda_ln, cuda_mha, ffn, mha

    gen = torch.Generator().manual_seed(SEED + 12)
    for name, b, lq, lk, d, self_attn, dt in WIDE_ATTN:
        args = _attention_args(gen, dev, dt, b, lq, lk, d, self_attn, True)
        es = args[0].element_size()
        f32 = dt == torch.float32
        work = (2.0 * (2 * b * lq * d * d + 2 * b * lk * d * d + 2 * b * lq * lk * d),
                2 * b * lq * d * es + 4 * d * d * 4 + 6 * d * 4 + b * lk, dt,
                F32_TC_FLOPS if f32 else None)
        check(cuda_mha.route(lq, lk, d, WIDE_HEADS, dt, self_attn=self_attn) == "tiled"
              and cuda_ln.row_plan(b * lq, d, dt, sms=1).warps == 2,
              f"mha_addln_tiled {name} D={d}: not the tiled chain over the wide rows")
        case = f"mha_addln_tiled {name} B={b} Lq={lq} Lk={lk} D={d} H={WIDE_HEADS}"
        ms, plain_ms = records["mha_addln_tiled"].add(
            case, dt,
            [(cuda_mha.mha_addln_cuda(*args, num_heads=WIDE_HEADS),
              mha.mha_addln_plain(*args, num_heads=WIDE_HEADS))],
            lambda a=args: cuda_mha.mha_addln_cuda(*a, num_heads=WIDE_HEADS),
            lambda a=args: mha.mha_addln_plain(*a, num_heads=WIDE_HEADS), work, counts=False,
            yardsticks={"stock_ms": _stock_attention_fn(args, dt, WIDE_HEADS)},
            info=_core_plan_info(lq, lk, d, dt, WIDE_HEADS))
        if f32:
            check(ms < plain_ms, f"{case}: {ms} ms, plain {plain_ms} ms (limit: faster than "
                  "plain)")
            _split_case(records["tf32_split"], "mha_addln_tiled", name,
                        [args[2], args[4], args[6], args[8]], False)
    for name, rows, d, f, dt in WIDE_FFN:
        args = _ffn_args(gen, dev, dt, rows, d, f)
        es = args[0].element_size()
        f32 = dt == torch.float32
        check(cuda_ffn.route(d, f, dt) == "tiled", f"ffn_addln_tiled {name} D={d}: not tiled")
        case = f"ffn_addln_tiled {name} R={rows} D={d} F={f}"
        ms, plain_ms = records["ffn_addln_tiled"].add(
            case, dt,
            [(cuda_ffn.ffn_addln_cuda(*args), ffn.ffn_addln_plain(*args))],
            lambda a=args: cuda_ffn.ffn_addln_cuda(*a),
            lambda a=args: ffn.ffn_addln_plain(*a),
            (4.0 * rows * d * f, 2 * rows * d * es + 2 * d * f * 4 + (f + 3 * d) * 4, dt,
             F32_TC_FLOPS if f32 else None),
            counts=False, yardsticks={"stock_ms": _stock_ffn_fn(args, dt)})
        if f32:
            check(ms < plain_ms, f"{case}: {ms} ms, plain {plain_ms} ms (limit: faster than "
                  "plain)")
        _ffn_tiled_stages(name, args, dt, records["tf32_split"])


# The training SA level's gradients are checked by relative L2 error, not
# by the largest element: the backward of the ReLUs is discontinuous, and
# the kernel's z differs from the plain version's in the last bits (another
# order of sums). Gradients whose exact value is near zero (db2, BN shift
# invariance) are sums of cancelling terms: their norm is floored at 1e-3 x
# the largest gradient norm of the case. The neighbour max moves the whole
# dout of a (center, column) to its winning edge: where two edges tie
# within f32 rounding, or the winner's pre-activation lies within rounding
# of the ReLU's kink, the kernel and the plain version can pick otherwise,
# each as exact as the other, and that one pair moves O(1) of gradient (a
# rel-L2 of about 1e-3 at the smoke's levels, which the limit's pass or
# fail would then leave to where such pairs fall). So both backwards take
# dout with zeros at the pairs sa_train.near_ties marks, where the gradient
# is not defined to within rounding (exact ties already split evenly), at
# the unchanged limits; the marked pairs may be at most NEAR_TIE_SHARE of a
# level's, and the unmasked errors are reported beside (rel_l2_errs_full).
SA_TRAIN_GRAD_FLOOR = 1e-3
NEAR_TIE_SHARE = 1e-5


def _bwd_info(level, aux1, aux2, n1, dout) -> dict:
    """The training backward's passes alone on the card: `stages`, ms of
    stats / mid / in with their reduce launches (median of 10 by CUDA
    events, each pass fed what the one before it gives), and per pass
    `tiles` (tiles, mean filled rows), `blocks_per_sm` (what
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives the kernel), tile
    `rows` and `resident` (W2 held in shared memory)."""
    acc2 = level.bwd_stats(aux1, aux2, dout)
    aux2b = aux2.clone()
    aux2b[4], aux2b[5] = acc2[0] / n1, acc2[1] / n1
    acc1 = level.bwd_mid(aux1, aux2b, dout)[0]
    aux1b = aux1.clone()
    aux1b[4], aux1b[5] = acc1[0] / n1, acc1[1] / n1
    stages = {"stats": cuda_ms(lambda: level.bwd_stats(aux1, aux2, dout)),
              "mid": cuda_ms(lambda: level.bwd_mid(aux1, aux2b, dout)),
              "in": cuda_ms(lambda: level.bwd_in(aux1b, aux2b, dout))}
    passes = (1, 2, 3)
    return {"stages": stages,
            "tiles": {str(p): level.bwd_tiles(p) for p in passes},
            "blocks_per_sm": {str(p): level.bwd_plan(p)[3] for p in passes},
            "rows": {str(p): level.bwd_plan(p)[0] for p in passes},
            "resident": {str(p): level.bwd_plan(p)[1] for p in passes}}


def _fwd_info(level, aux1, aux2) -> dict:
    """The training forward's passes alone on the card: `stages`, ms of
    stats1 / stats2 / out with their reduce launches (median of 10 by CUDA
    events, each fed the forward's aux rows), and per pass the plan:
    `blocks_per_sm` (what cudaOccupancyMaxActiveBlocksPerMultiprocessor
    gives the kernel), the grid `blocks`, tile `rows` and `resident` (W2
    held in shared memory; stats1 takes no tiles: 0, 0), and for the two
    passes that form z `tiles` (tiles, mean filled rows)."""
    stages = {"stats1": cuda_ms(lambda: level.stats(1, aux1, aux2)),
              "stats2": cuda_ms(lambda: level.stats(2, aux1, aux2)),
              "out": cuda_ms(lambda: level.out(aux1, aux2))}
    passes = (1, 2, 3)
    return {"stages": stages,
            "tiles": {str(p): level.fwd_tiles(p) for p in (2, 3)},
            "blocks_per_sm": {str(p): level.fwd_plan(p)[3] for p in passes},
            "blocks": {str(p): level.fwd_blocks(p) for p in passes},
            "rows": {str(p): level.fwd_plan(p)[0] for p in passes},
            "resident": {str(p): level.fwd_plan(p)[1] for p in passes}}


def _sa_train_bwd_case(record, name, dt, level, aux1, aux2, n1, dout, plain, cache_dtype,
                       args, work, counts):
    """One backward case line: backward_cuda at the forward's aux rows
    against `plain(dout)` (the hand-derived plain backward at the same
    rows), both fed dout with zeros at the level's near-ties (see
    SA_TRAIN_GRAD_FLOOR), with `near_ties`, `near_tie_share` and the
    unmasked errors `rel_l2_errs_full` on the line."""
    from text2loc_tpu_torch.ops import sa_train

    u, sv, w2, idx, maskm = args
    ties = sa_train.near_ties(u, sv, w2, idx, maskm, aux1, aux2, dt, cache_dtype)
    count = int(ties.sum().item())
    share = count / max(ties.numel(), 1)
    full_want = plain(dout)
    full_floor = SA_TRAIN_GRAD_FLOOR * max(w.norm().item() for w in full_want)
    full = [((g - w).norm() / max(w.norm().item(), full_floor)).item() for g, w in
            zip(sa_train.backward_cuda(level, aux1, aux2, n1, dout), full_want)]
    dout_m = dout.masked_fill(ties, 0.0)
    want = plain(dout_m)
    floor = SA_TRAIN_GRAD_FLOOR * max(w.norm().item() for w in want)
    record.add(
        name, dt, list(zip(sa_train.backward_cuda(level, aux1, aux2, n1, dout_m), want)),
        lambda: sa_train.backward_cuda(level, aux1, aux2, n1, dout_m),
        lambda: plain(dout_m), work, norm_floor=floor, counts=counts,
        info={**_bwd_info(level, aux1, aux2, n1, dout_m), "near_ties": count,
              "near_tie_share": share, "rel_l2_errs_full": full})
    check(share <= NEAR_TIE_SHARE,
          f"{name} {dt}: near-ties {count} of {ties.numel()} pairs (limit: a share of "
          f"{NEAR_TIE_SHARE})")


def phase_sa_train_kernels(dev) -> dict:
    """sa_train_fwd / sa_train_bwd against the plain forward and the plain
    hand-derived backward at the coarse train step's three levels: 896
    clouds (32 cells x 28 objects, a quarter of them padding objects out
    of the statistics), exact nearest-32 neighbours from the real ball
    query of FPS centers, random u / sv / weights and cotangent."""
    from text2loc_tpu_torch.ops import cuda_fps, cuda_sa_train, sa_train
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    gen = torch.Generator().manual_seed(SEED + 3)
    records = {k: KernelRecord() for k in ("sa_train_fwd", "sa_train_bwd", "sa_train_e_fwd",
                                          "sa_train_e_bwd")}
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
            level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt)
            records["sa_train_fwd"].add(
                f"sa_train_fwd {tag}", dt,
                [(out, want_out)] + list(zip(stats, want_stats)), fwd,
                lambda dt=dt: sa_train.sa_train_plain(
                    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, compute_dtype=dt),
                (2.0 * edges * h1 * h2, io_bytes + n * s * h2 * 4, dt, _sa_peak(dt)),
                counts=dt == torch.float32, info=_fwd_info(level, aux1, aux2))
            n1 = stats[4]
            _sa_train_bwd_case(
                records["sa_train_bwd"], f"sa_train_bwd {tag}", dt, level, aux1, aux2, n1,
                dout,
                lambda d, dt=dt, a1=aux1, a2=aux2, c=n1: sa_train.sa_train_backward_plain(
                    u, sv, w2, idx, maskm, maskf, a1, a2, c, d, dt),
                None, (u, sv, w2, idx, maskm),
                (4.0 * edges * h1 * h2,
                 io_bytes + n * s * h2 * 4
                 + (n * p * h1 + n * s * h1 + h1 * h2 + 2 * h1 + 3 * h2) * 4, dt, _sa_peak(dt)),
                dt == torch.float32)
            _sa_train_e_cases(records, tag, dt, edges, io_bytes,
                              (u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf), dout)
        pos = ctr
    torch.cuda.synchronize()
    return records


def _sa_train_e_cases(records, tag, dt, edges, io_bytes, args, dout):
    """The level of the token "e" (e rounded to bf16, the JAX kernel's bf16
    cache) against its plain forward and hand-derived plain backward.
    Counted in bf16, the train_optin path's compute dtype. Bound: the
    recompute level's, since the function needs no more (its inputs and
    outputs; the products at the dtype's peak)."""
    from text2loc_tpu_torch.ops import cuda_sa_train, sa_train

    u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf = args
    n, s, k = idx.shape
    h1, h2 = w2.shape
    bf16 = torch.bfloat16

    def fwd():
        level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, dt, bf16)
        return sa_train.forward_cuda(level, b2, g1, be1, g2, be2, maskf, 1e-5) + (level,)

    def plain():
        return sa_train.sa_train_plain(*args, compute_dtype=dt, cache_dtype=bf16)

    out, stats, aux1, aux2, level = fwd()
    want_out, want_stats = plain()
    records["sa_train_e_fwd"].add(
        f"sa_train_e_fwd {tag}", dt, [(out, want_out)] + list(zip(stats, want_stats)), fwd,
        plain, (2.0 * edges * h1 * h2, io_bytes + n * s * h2 * 4, dt, _sa_peak(dt)),
        counts=dt == bf16, info=_fwd_info(level, aux1, aux2))
    n1 = stats[4]
    _sa_train_bwd_case(
        records["sa_train_e_bwd"], f"sa_train_e_bwd {tag}", dt, level, aux1, aux2, n1, dout,
        lambda d: sa_train.sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1, aux2,
                                                   n1, d, dt, bf16),
        bf16, (u, sv, w2, idx, maskm),
        (4.0 * edges * h1 * h2,
         io_bytes + n * s * h2 * 4
         + (n * u.shape[1] * h1 + n * s * h1 + h1 * h2 + 2 * h1 + 3 * h2) * 4, dt,
         _sa_peak(dt)),
        dt == bf16)


def _ulp_limit(dtype):
    """The add+LN kernel's limit: f32 within 1e-6 x max|plain|; bf16 within
    one bf16 ulp of max(|plain|, 2^-8) per element. Below 2^-8 an output is
    the cancellation of terms of order 0.1-1 (the affine's bias against the
    normalized value), where the two f32 computations differ by more than
    the bf16 spacing at the result."""
    def limit(got, want):
        err = (got - want).abs()
        if dtype == torch.float32:
            lim = 1e-6 * want.abs().max().item()
            return err.max().item(), lim, err.max().item() <= lim, None
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -8))) - 7)
        return (err.max().item(), (ulp * 1.0).max().item(), bool((err <= ulp).all()),
                (err / ulp).max().item())
    return limit


def _rel_limit(got, want):
    """Within 1e-6 x max|plain| (the scatter-add: sums in another order)."""
    err = (got - want).abs().max().item()
    lim = 1e-6 * want.abs().max().item()
    return err, lim, err <= lim, None


# Gallery shapes of SA mode off's neighbour gather (P, Q = S x K, C + 3), and
# the training gather probe's (P, Q, H1) (scripts/probe_gather_train.py).
GATHER_GALLERY = [(256, 128 * 32, 6), (128, 64 * 32, 67), (64, 32 * 32, 131)]
GATHER_PROBE = [(256, 128 * 32, 32), (128, 64 * 32, 128), (64, 32 * 32, 256)]


def phase_optin_kernels(dev) -> dict:
    """add_ln (at the serve's widths and at every layout of the row routine:
    the half-warp, one warp, and 2 and 8 warps a row), gather_rows and
    gather_rows_scatter against their plain versions, with the time of one
    PyTorch call for the same function:
    F.layer_norm(x + res), torch.gather, and ATen's scatter_add_ (the
    backward of torch.gather), both over an expanded view of the int64
    index, cast outside the timing."""
    from text2loc_tpu_torch.ops import _cuda, cuda_gather, cuda_ln, gather, ln

    gen = torch.Generator().manual_seed(SEED + 8)
    records = {k: KernelRecord() for k in ("add_ln", "gather_rows", "gather_rows_scatter")}
    # (name, rows, D, dtypes, summed): the E=1024 trunk (1584 sentences x 16
    # tokens), the CCT's rows, obj_inter's rows; then the trunk's rows at
    # the widths the JAX gate opens past the add+LN block's own: 384 and 768
    # (one warp a row), 2048 in f32 and 4096 in bf16 (two warps a row, the
    # wide layout) and the routine's limits, 8192 in f32 and 16384 in bf16
    # (eight warps a row), lines of their own, not summed, with inputs from
    # a generator of their own (the other cases keep theirs).
    ln_cases = [(name, rows, d, (torch.bfloat16, torch.float32), True)
                for name, rows, d in [("intra E=1024", 1584 * 16, 1024), ("cct", 640 * 16, 128),
                                      ("obj_inter", 64 * 28, 256)]]
    ln_cases += [("width", 1584 * 16, 384, (torch.bfloat16, torch.float32), False),
                 ("width", 1584 * 16, 768, (torch.bfloat16, torch.float32), False),
                 ("wide", 1584 * 4, 2048, (torch.float32,), False),
                 ("wide", 1584 * 4, 4096, (torch.bfloat16,), False),
                 ("limit", 1584 * 4, 8192, (torch.float32,), False),
                 ("limit", 1584 * 4, 16384, (torch.bfloat16,), False)]
    gen_widths = torch.Generator().manual_seed(SEED + 11)
    for name, rows, d, dts, summed in ln_cases:
        gl = gen if summed else gen_widths
        for dt in dts:
            x = _rand(gl, (rows, d), 2.0, dev, 0.3).to(dt)
            res = _rand(gl, (rows, d), 1.0, dev).to(dt)
            g, b = _rand(gl, d, 0.1, dev, 1.0), _rand(gl, d, 0.1, dev)
            es = x.element_size()
            plan = cuda_ln.row_plan(rows, d, dt, sms=_cuda.sm_count(dev.index or 0))
            records["add_ln"].add(
                f"add_ln {name} R={rows} D={d}", dt,
                [(cuda_ln.add_layernorm_cuda(x, res, g, b), ln.add_layernorm_plain(x, res, g, b))],
                lambda a=(x, res, g, b): cuda_ln.add_layernorm_cuda(*a),
                lambda a=(x, res, g, b): ln.add_layernorm_plain(*a),
                (9.0 * rows * d, 3 * rows * d * es + 2 * d * 4, torch.float32),
                counts=None if summed else False, limit_fn=_ulp_limit(dt),
                library_fn=lambda a=(x, res, g, b), d=d: torch.nn.functional.layer_norm(
                    a[0] + a[1], (d,), a[2].to(a[0].dtype), a[3].to(a[0].dtype), 1e-5),
                info={"kernel_ms": kernel_ms(lambda a=(x, res, g, b):
                                             cuda_ln.add_layernorm_cuda(*a)),
                      "rows_per_warp": plan.rows_per_warp, "warps": plan.warps,
                      "chunks": plan.chunks, "blocks": plan.blocks, "per_sm": plan.per_sm})
    # Past the routine's limit: ValueError before any launch.
    for d, dt in ((8192 + 128, torch.float32), (16384 + 128, torch.bfloat16)):
        x = torch.zeros((4, d), device=dev, dtype=dt)
        g = torch.ones(d, device=dev)
        before = cuda_ln.KERNEL.launches
        try:
            cuda_ln.add_layernorm_cuda(x, x, g, g)
            refused = False
        except ValueError:
            refused = True
        check(refused and cuda_ln.KERNEL.launches == before,
              f"add_ln D={d} {dt}: past the row routine's limit, not refused before launch")

    def gather_case(n, p, q, c, dt, counts, tag):
        values = _rand(gen, (n, p, c), 1.0, dev).to(dt)
        idx = torch.randint(0, p, (n, q), generator=gen).to(torch.int32).to(dev)
        full = idx.long()[..., None].expand(n, q, c)      # a view: no [N, Q, C] index
        es = values.element_size()
        plan = cuda_gather.gather_plan(n, p, q, c * es, sms=_cuda.sm_count(dev.index or 0))
        records["gather_rows"].add(
            f"gather_rows {tag} N={n} P={p} Q={q} C={c}", dt,
            [(cuda_gather.gather_rows_cuda(values, idx), gather.gather_rows_plain(values, idx))],
            lambda: cuda_gather.gather_rows_cuda(values, idx),
            lambda: gather.gather_rows_plain(values, idx),
            (0.0, n * p * c * es + n * q * 4 + n * q * c * es, torch.float32), exact=True,
            counts=counts, library_fn=lambda: torch.gather(values, 1, full),
            info={"kernel_ms": kernel_ms(lambda: cuda_gather.gather_rows_cuda(values, idx)),
                  "word": plan.word, "chunk_bytes": plan.chunk_bytes, "chunks": plan.chunks})
        return values, idx, full

    for dt in (torch.bfloat16, torch.float32):
        for p, q, c in GATHER_GALLERY:
            gather_case(64 * 28, p, q, c, dt, dt == torch.bfloat16, "gallery")
    for p, q, c in GATHER_PROBE:
        n = 32 * 28
        _, idx, full = gather_case(n, p, q, c, torch.float32, False, "probe")
        g = _rand(gen, (n, q, c), 1.0, dev)
        records["gather_rows_scatter"].add(
            f"gather_rows_scatter probe N={n} P={p} Q={q} C={c}", torch.float32,
            [(cuda_gather.scatter_rows_cuda(g, idx, p),
              gather.scatter_rows_plain(g.cpu(), idx.cpu(), p).to(dev))],
            lambda: cuda_gather.scatter_rows_cuda(g, idx, p),
            lambda: gather.scatter_rows_plain(g, idx, p),
            (1.0 * n * q * c, n * q * c * 4 + n * q * 4 + n * p * c * 4, torch.float32),
            counts=True, limit_fn=_rel_limit,
            library_fn=lambda: torch.zeros((n, p, c), device=dev).scatter_add_(1, full, g))
    torch.cuda.synchronize()
    return records


# ------------------------------------------------------------------- layers

# The transformer layers at widths between the serve's: d_model 384 and 768
# (heads of 64, F = 4D), 64 samples of 16 tokens over 6 memory tokens, one
# sample's memory fully masked; f32. Each gate set's kernels must launch and
# the other's not: the tiled chains (and, in f32, the split of their
# weights) under "all", add_ln after stock blocks.
LAYER_WIDTHS = (384, 768)
LAYER_GATES = {"attn_ffn_all": (dict(attn="all", ffn="all"),
                                ("mha_addln_tiled", "ffn_addln_tiled", "tf32_split"),
                                ("add_ln", "mha_addln", "ffn_addln")),
               "stock_ln_all": (dict(attn="0", ffn="0", ln="all"), ("add_ln",),
                                ("mha_addln_tiled", "ffn_addln_tiled", "mha_addln",
                                 "ffn_addln", "tf32_split"))}


def phase_layers(dev, kernels) -> dict:
    """EncoderLayer and DecoderLayer (models/transformer.py) in f32 on the
    card against the CPU (the plain versions) at LAYER_WIDTHS under each of
    LAYER_GATES, seeded weights: max |card - CPU| within TOLERANCE x
    max|CPU|, the card's median ms a call, and the launches of `kernels`
    over the card's calls."""
    import copy

    from text2loc_tpu_torch.convert import init_weights
    from text2loc_tpu_torch.models.transformer import DecoderLayer, EncoderLayer, Gates

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 13)
    b, lt, lm = 64, 16, 6
    report, totals = {"phase": "layers", "dtype": "float32", "cases": []}, {}
    for name, (gates, want_on, want_off) in LAYER_GATES.items():
        for d in LAYER_WIDTHS:
            heads = d // 64
            x = torch.randn(b, lt, d, generator=gen)
            mem = torch.randn(b, lm, d, generator=gen)
            xm, mm = torch.rand(b, lt, generator=gen) > 0.3, torch.rand(b, lm, generator=gen) > 0.3
            xm[:, 0] = mm[:, 0] = True
            mm[1] = False
            for cls, inputs in ((EncoderLayer, (x, xm)), (DecoderLayer, (x, mem, xm, mm))):
                cpu = init_weights(cls(d, heads, 4 * d, gates=Gates(**gates)), gen).eval()
                card = copy.deepcopy(cpu).to(dev)
                on_card = [t.to(dev) for t in inputs]
                for k in kernels:
                    k.launches = 0
                with torch.no_grad():
                    want = cpu(*inputs)
                    got = card(*on_card)
                    counts = {k.name: k.launches for k in kernels}
                    ms = cuda_ms(lambda: card(*on_card))
                err = (got.cpu() - want).abs().max().item()
                limit = TOLERANCE[torch.float32] * want.abs().max().item()
                case = {"gates": name, "layer": cls.__name__, "d_model": d, "heads": heads,
                        "max_abs_err": err, "bound": limit, "ms": ms, "launches": counts}
                report["cases"].append(case)
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                check(bool(torch.isfinite(got).all()) and err <= limit,
                      f"layers {name} {cls.__name__} d={d}: card vs CPU {err} above {limit}")
                check(all(counts[k] > 0 for k in want_on)
                      and all(counts[k] == 0 for k in want_off),
                      f"layers {name} {cls.__name__} d={d}: launches {counts}")
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    return totals


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


def _models(cfg, gen, **kw):
    from text2loc_tpu_torch.convert import build_model, init_weights

    return (init_weights(build_model(cfg, "coarse", **kw), gen),
            init_weights(build_model(cfg, "fine", **kw), gen))


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


def _check_absent(counts: dict, absent, what: str) -> None:
    """The opt-in kernels stay off the default paths."""
    off = {k.name: counts[k.name] for k in absent}
    check(all(v == 0 for v in off.values()), f"{what}: an opt-in kernel launched: {off}")


def phase_serve(dev, kernels, absent=(), options=None, phase="serve") -> dict:
    """The cached serve at full Config() width (bf16), the models built
    with build_model's `options`: build seconds, the median latency of
    batches of 1, 8 and 64, and the launches of the build alone and of the
    whole phase."""
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    cfg = Config()
    data = _map(2, 32, cfg)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED), **(options or {}))
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    for k in (*kernels, *absent):
        k.launches = 0
    t0 = time.perf_counter()
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = {k.name: k.launches for k in (*kernels, *absent)}
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
    counts = {k.name: k.launches for k in (*kernels, *absent)}
    emit({"phase": phase, "config": "Config() bf16", "options": options or {},
          "cells": data.num_cells, "top_k": loc.top_k, "build_s": build_s,
          "median_ms_per_batch": latency, "build_launches": build_counts,
          "launches": counts})
    check(all(counts[k.name] > 0 for k in kernels), f"a kernel never launched: {counts}")
    _check_absent(counts, absent, phase)
    return counts


# The serve kernels a traced batch-8 localize launches, by the name of
# their CUDA function in the trace's kernel events. The profiler at times
# drops device events from a window (tests/test_torch_port_cuda.py
# PROFILER_WINDOWS): such a window is taken again, up to TRACE_WINDOWS.
TRACE_EVENTS = {"mha_addln": "mha_addln_kernel", "ffn_addln": "ffn_addln_kernel"}
TRACE_WINDOWS = 5


def phase_trace(dev, kernels, smi: str) -> dict:
    """utils/profiling.profile_trace around one batch-8 Localizer.localize
    of phase 4's serve on the card: the written *.pt.trace.json holds as
    many kernel events of mha_addln and ffn_addln as their launch counters
    count in that window (and no other kernel of `kernels` launched).
    Returns the launches of the window taken."""
    import glob
    import tempfile

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer
    from text2loc_tpu_torch.utils.profiling import profile_trace

    cfg = Config()
    data = _map(2, 32, cfg)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED))
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev)
    q = np.arange(8) % data.num_poses
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    loc.localize(*args)
    torch.cuda.synchronize()
    report = {"phase": "trace", "card": smi, "batch": 8}
    with tempfile.TemporaryDirectory() as tmp:
        for window in range(1, TRACE_WINDOWS + 1):
            log_dir = os.path.join(tmp, f"window{window}")
            for k in kernels:
                k.launches = 0
            t = time.perf_counter()
            with profile_trace(log_dir):
                res = loc.localize(*args)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            counts = {k.name: k.launches for k in kernels}
            files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
            check(len(files) == 1, f"trace window {window}: trace files {files}")
            with open(files[0]) as f:
                trace = json.load(f)
            kernel_events = [e for e in trace.get("traceEvents", [])
                             if isinstance(e, dict) and e.get("cat") == "kernel"]
            events = {k: sum(fn in e.get("name", "") for e in kernel_events)
                      for k, fn in TRACE_EVENTS.items()}
            if all(events[k] == counts[k] for k in TRACE_EVENTS):
                break
            check(all(events[k] <= counts[k] for k in TRACE_EVENTS),
                  f"trace window {window}: more kernel events than launches: {events} "
                  f"against {counts}")
        report.update({
            "windows": window, "trace_file": os.path.basename(files[0]),
            "trace_bytes": os.path.getsize(files[0]), "kernel_events": len(kernel_events),
            "kernel_ms": sum(e.get("dur", 0) for e in kernel_events) / 1e3,
            "events": events, "launches": counts, "traced_wall_ms": wall_ms})
    emit(report)
    _check_result(res, data, 8, loc.top_k)
    check(all(counts[k] > 0 for k in TRACE_EVENTS), f"the traced batch launched {counts}")
    check(events == {k: counts[k] for k in TRACE_EVENTS},
          f"no trace window of {TRACE_WINDOWS} held every launch: events {events}, "
          f"launches {counts}")
    others = {k: v for k, v in counts.items() if k not in TRACE_EVENTS and v}
    check(not others, f"the traced batch launched kernels the trace check does not read: "
                      f"{others}")
    return counts


def _top1_agreement(got, want) -> tuple:
    """(rows compared, top-1 equal, max position error in m over the rows
    with the same top-1): rows whose top-1/top-2 margin in `want` exceeds
    1e-4 are compared."""
    margin = want.scores[:, 0] - want.scores[:, 1]
    sure = margin > 1e-4
    top1_equal = bool((got.cell_indices[sure, 0] == want.cell_indices[sure, 0]).all())
    same = sure & (got.cell_indices[:, 0] == want.cell_indices[:, 0])
    pos_err = (float(np.abs(got.position_w[same] - want.position_w[same]).max())
               if same.any() else float("inf"))
    return int(sure.sum()), top1_equal, pos_err


def phase_serve_vs_cpu(dev) -> None:
    """The f32 serve on the card and on the CPU over an 8-cell map, by path:
    the cached serve (localize), the stepwise path (precompute_fine=False)
    and localize_embedded of the embedder's own token embeddings."""
    import dataclasses

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    t_phase = time.perf_counter()
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, dtype="float32"))
    data = _map(1, 8, cfg)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    q = np.arange(16) % data.num_poses
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    text = emb.embed(*args)
    embedded = (text.token_embeds.numpy(), text.token_mask.numpy(),
                text.sentence_mask.numpy())
    results = {}
    for where in ("cuda", "cpu"):
        coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 1))
        device = dev if where == "cuda" else "cpu"
        loc = Localizer(data, coarse, fine, emb, cfg, top_k=5, device=device)
        step = Localizer(data, coarse, fine, emb, cfg, top_k=5, device=device,
                         precompute_fine=False)
        results[where] = {"cached": loc.localize(*args), "stepwise": step.localize(*args),
                          "embedded": loc.localize_embedded(*embedded)}
    report = {"phase": "serve_vs_cpu", "cells": data.num_cells, "queries": len(q)}
    for path, cpu in results["cpu"].items():
        gpu = results["cuda"][path]
        compared, top1_equal, pos_err = _top1_agreement(gpu, cpu)
        report[path] = {"compared": compared, "top1_equal": top1_equal,
                        "max_pos_err_m": pos_err,
                        "max_score_err": float(np.abs(gpu.scores - cpu.scores).max())}
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    for path in results["cpu"]:
        r = report[path]
        check(r["top1_equal"], f"{path}: top-1 cell differs between the card and the CPU")
        check(r["max_pos_err_m"] <= 1e-2,
              f"{path}: positions differ by {r['max_pos_err_m']} m between the card "
              "and the CPU")


# ----------------------------------------------------------------- pipeline

# The mode table of scripts/validate_kernels.py, as the port's model
# arguments: "exact" there is the plain nearest-K path ("off"); "1" is
# the exact mode of fused_set_abstraction.
PIPELINE_MODES = {
    "exact": dict(sa_mode="off", approx_neighbors=False),
    "gather_exact": dict(sa_mode="gather", approx_neighbors=False),
    "gather_approx": dict(sa_mode="gather", approx_neighbors=True),
    "fused_full": dict(sa_mode="full"),
    "fused_mixed": dict(sa_mode="full,full,all"),
    "fused_all": dict(sa_mode="all"),
    "fused_first": dict(sa_mode="first"),
    "fused_first_mixed": dict(sa_mode="first,first,all"),
    "fused_exact": dict(sa_mode="1"),
    "approx_knn": dict(sa_mode="off", approx_neighbors=True),
}
# The inference SA kernels each mode must launch, and no other.
_MODE_SA = {"off": (), "first": ("sa_select_first",), "full": ("sa_select_bisect",),
            "gather": ("sa_gather",), "exact": ("sa_exact",), "all": ("sa_all",)}


def _mode_sa_kernels(kw) -> set:
    from text2loc_tpu_torch.models.pointnet2 import sa_mode_list

    return {name for m in sa_mode_list(kw["sa_mode"], 3) for name in _MODE_SA[m]}


def _mode_models(cfg, state, kw, dev):
    """The two towers in SA mode `kw`, with the weights of `state`."""
    from text2loc_tpu_torch.convert import build_model

    models = []
    for kind in ("coarse", "fine"):
        model = build_model(cfg, kind, **kw)
        model.load_state_dict(state[kind])
        models.append(model.to(dev).eval())
    return models


def _agreement(base, r, data) -> dict:
    """Top-1 retrieval agreement with the baseline and the mean |delta pos|
    in metres over the (pose, candidate) pairs that retrieved the same cell
    (scripts/validate_kernels.py's measures)."""
    agree = base["retrievals"][:, 0] == r["retrievals"][:, 0]
    same = base["retrievals"] == r["retrievals"]
    d = np.linalg.norm((base["pos_in_cells"] - r["pos_in_cells"])[same], axis=-1)
    sizes = data.cell_size[r["retrievals"]][same]
    return {"top1_agreement": float(agree.mean()),
            "mean_abs_dpos_m": float((d * sizes).mean()) if same.any() else None}


def phase_pipeline(dev, kernels, absent=()) -> dict:
    """run_pipeline at full Config() width (bf16) over the serve's 64-cell
    map with seeded random weights, once per mode of the sweep table: wall
    seconds, fine_qps, each table's top-1 row, agreement with the "exact"
    (off) baseline, and the launches of the mode's kernels."""
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    cfg = Config()
    data = _map(2, 32, cfg)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 6))
    state = {"coarse": coarse.state_dict(), "fine": fine.state_dict()}
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens, device=dev)
    totals = {k.name: 0 for k in (*kernels, *absent)}
    base = None
    for mode, kw in PIPELINE_MODES.items():
        cm, fm = _mode_models(cfg, state, kw, dev)
        if base is None:      # warm-up of the baseline: allocator, cuBLAS
            run_pipeline(data, cm, fm, emb, cfg, device=dev, verbose=False)
        for k in (*kernels, *absent):
            k.launches = 0
        t0 = time.perf_counter()
        r = run_pipeline(data, cm, fm, emb, cfg, device=dev, verbose=False)
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in (*kernels, *absent)}
        base = base or r
        check(bool(np.isfinite(r["pos_in_cells"]).all()), f"{mode}: non-finite positions")
        k = min(max(cfg.eval.top_k), data.num_cells)
        check(r["retrievals"].shape == (data.num_poses, k),
              f"{mode}: retrievals {r['retrievals'].shape}")
        emit({"phase": "pipeline", "mode": mode, "sa_mode": kw["sa_mode"],
              "approx_neighbors": kw.get("approx_neighbors"), "poses": data.num_poses,
              "cells": data.num_cells, "wall_s": wall, "fine_qps": r["fine_qps"],
              "coarse_top1": r["coarse"][1], "fine_top1": r["fine"][1],
              **_agreement(base, r, data), "launches": counts})
        want = _mode_sa_kernels(kw) | {"fps", "mha_addln", "mha_addln_tiled", "ffn_addln"}
        check(all(counts[name] > 0 for name in want),
              f"{mode}: a kernel of the mode never launched: {counts}")
        check(all(counts[name] == 0 for name in SA_KERNELS if name not in want),
              f"{mode}: an SA kernel of another mode launched: {counts}")
        _check_absent(counts, absent, f"pipeline {mode}")
        for name, v in counts.items():
            totals[name] += v
    return totals


# The opt-in evaluation paths, as build_model's options: the LN kernel at
# every width with stock feed-forward blocks before it (mode first), the
# row-gather kernel in mode off with stock attention blocks, every
# attention block on its kernel (fused_attn="all": in f32 the E=1024 stack
# too, on the tiled chain), every feed-forward block on its kernel
# (fused_ffn="all": the E=1024 stack's on the tiled chain, bf16 and f32;
# in f32 after stock attention), and both.
PIPELINE_OPTIN = {
    "ln_all_ffn0": dict(sa_mode="first", fused_ln="all", fused_ffn="0"),
    "off_vmem_attn0": dict(sa_mode="off", vmem_gather=True, fused_attn="0"),
    "attn_all": dict(sa_mode="first", fused_attn="all"),
    "ffn_all": dict(sa_mode="first", fused_ffn="all"),
    "attn_ffn_all": dict(sa_mode="first", fused_attn="all", fused_ffn="all"),
}
# The kernels each path must launch besides FPS and its SA kernels.
_OPTIN_KERNELS = {"ln_all_ffn0": ("mha_addln", "mha_addln_tiled", "add_ln"),
                  "off_vmem_attn0": ("ffn_addln", "add_ln", "gather_rows"),
                  "attn_all": ("mha_addln", "mha_addln_tiled", "ffn_addln"),
                  "ffn_all": ("mha_addln", "mha_addln_tiled", "ffn_addln",
                              "ffn_addln_tiled"),
                  "attn_ffn_all": ("mha_addln", "mha_addln_tiled", "ffn_addln",
                                   "ffn_addln_tiled")}


def phase_pipeline_optin(dev, kernels) -> dict:
    """run_pipeline at full Config() width (bf16) over phase 6's map and
    weights: the default (mode first, default gates) once for a warm-up
    and once as the baseline, then each opt-in path: wall seconds,
    fine_qps, top-1 rows, agreement with the default run, launches."""
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    cfg = Config()
    data = _map(2, 32, cfg)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 6))
    state = {"coarse": coarse.state_dict(), "fine": fine.state_dict()}
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens, device=dev)
    cm, fm = _mode_models(cfg, state, dict(sa_mode="first"), dev)
    run_pipeline(data, cm, fm, emb, cfg, device=dev, verbose=False)
    t0 = time.perf_counter()
    base = run_pipeline(data, cm, fm, emb, cfg, device=dev, verbose=False)
    emit({"phase": "pipeline_optin", "mode": "default", "sa_mode": "first",
          "wall_s": time.perf_counter() - t0, "fine_qps": base["fine_qps"]})
    totals = {k.name: 0 for k in kernels}
    for mode, kw in PIPELINE_OPTIN.items():
        cm, fm = _mode_models(cfg, state, kw, dev)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        r = run_pipeline(data, cm, fm, emb, cfg, device=dev, verbose=False)
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels}
        check(bool(np.isfinite(r["pos_in_cells"]).all()), f"{mode}: non-finite positions")
        k = min(max(cfg.eval.top_k), data.num_cells)
        check(r["retrievals"].shape == (data.num_poses, k),
              f"{mode}: retrievals {r['retrievals'].shape}")
        emit({"phase": "pipeline_optin", "mode": mode, "options": kw,
              "poses": data.num_poses, "cells": data.num_cells, "wall_s": wall,
              "fine_qps": r["fine_qps"], "coarse_top1": r["coarse"][1],
              "fine_top1": r["fine"][1], **_agreement(base, r, data), "launches": counts})
        want = _mode_sa_kernels(kw) | {"fps", *_OPTIN_KERNELS[mode]}
        check(all(counts[name] > 0 for name in want),
              f"{mode}: a kernel of the path never launched: {counts}")
        for name, v in counts.items():
            totals[name] += v
    return totals


def _retrieval_margin(data, model, emb, cfg) -> np.ndarray:
    """Top-1 minus top-2 retrieval score per query, on the CPU."""
    from text2loc_tpu_torch.evaluation.retrieval import (encode_gallery, encode_queries,
                                                         topk_retrieval)

    with torch.no_grad():
        scores, _ = topk_retrieval(encode_gallery(data, model, cfg, "cpu"),
                                   encode_queries(data, model, emb, cfg, "cpu"), 2)
    return (scores[:, 0] - scores[:, 1]).numpy()


def phase_pipeline_vs_cpu(dev, modes=None, phase="pipeline_vs_cpu") -> None:
    """The same f32 weights through run_pipeline on the card and on the CPU
    (plain versions) over an 8-cell map, in every mode of `modes` (default
    PIPELINE_MODES): top-1 cells equal where the CPU's top-1/top-2 margin
    exceeds 1e-4, positions of the pairs that retrieved the same cell
    within 1e-2 m, and both tables equal where every retrieval agrees."""
    import dataclasses

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, dtype="float32"))
    data = _map(1, 8, cfg)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 7))
    state = {"coarse": coarse.state_dict(), "fine": fine.state_dict()}
    rows = {}
    for mode, kw in (modes or PIPELINE_MODES).items():
        got = run_pipeline(data, *_mode_models(cfg, state, kw, dev), emb, cfg,
                           device=dev, verbose=False)
        cm, fm = _mode_models(cfg, state, kw, "cpu")
        want = run_pipeline(data, cm, fm, emb, cfg, device="cpu", verbose=False)
        sure = _retrieval_margin(data, cm, emb, cfg) > 1e-4
        top1_equal = bool((got["retrievals"][sure, 0] == want["retrievals"][sure, 0]).all())
        same = got["retrievals"] == want["retrievals"]
        dpos = np.abs(got["pos_in_cells"] - want["pos_in_cells"])[same]
        dpos = dpos * data.cell_size[want["retrievals"]][same][:, None]
        pos_err = float(dpos.max()) if dpos.size else float("inf")
        all_agree = bool(same.all())
        tables_equal = got["coarse"] == want["coarse"] and got["fine"] == want["fine"]
        rows[mode] = {"compared": int(sure.sum()), "top1_equal": top1_equal,
                      "retrievals_equal": all_agree, "max_pos_err_m": pos_err,
                      "tables_equal": tables_equal}
        check(top1_equal and int(sure.sum()) > 0,
              f"{mode}: top-1 cell differs between the card and the CPU")
        check(pos_err <= 1e-2, f"{mode}: positions differ by {pos_err} m")
        check(tables_equal or not all_agree, f"{mode}: tables differ: {got}, {want}")
    emit({"phase": phase, "cells": data.num_cells, "poses": data.num_poses,
          "modes": rows})


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


# NEIGHBOR_KEYS order: east, west, north, south, northeast, northwest,
# southeast, southwest, as grid steps.
_COMPASS = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1), (1, -1), (-1, -1))


def _with_pmc(scene, seed: int):
    """The scene with PMC tables: each cell's compass neighbours on make_scene's
    grid, and seeded tables over them (half the (pose, neighbour) pairs
    valid, random weights, random re-matched slots with misses)."""
    import dataclasses
    import math

    rng = np.random.default_rng(seed)
    c, n = scene.num_cells, scene.num_poses
    grid = math.ceil(math.sqrt(c))
    neighbors = np.full((c, 8), -1, np.int32)
    for i in range(c):
        for k, (dx, dy) in enumerate(_COMPASS):
            x, y = i % grid + dx, i // grid + dy
            if 0 <= x < grid and y >= 0 and y * grid + x < c:
                neighbors[i, k] = y * grid + x
    valid = (neighbors[scene.pose_cell_idx] >= 0) & (rng.random((n, 8)) < 0.5)
    weight = np.where(valid, rng.uniform(0.5, 4.0, (n, 8)), 0.0).astype(np.float32)
    match = rng.integers(-1, scene.obj_xyz.shape[1],
                         (n, 8, scene.hint_obj_idx.shape[1])).astype(np.int32)
    return dataclasses.replace(scene, cell_neighbors=neighbors, pmc_valid=valid,
                               pmc_weight=weight, pmc_match=match)


def _val_map(cfg, num_poses: int):
    """_train_map's cells with poses of their own (a validation split)."""
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene

    m = cfg.model
    return MultiSceneArrays([make_scene(
        "0100", num_cells=32, num_poses=num_poses, object_slots=m.object_size,
        num_points=m.pointnet.num_points, num_mentioned=m.num_mentioned, seed=SEED + 5,
        pose_seed=SEED + 6)])


def _host_copy(tree):
    """A nested state dict with every tensor copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _state_equal(a, b) -> bool:
    """Nested state dicts equal bit for bit (tensors by torch.equal)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_state_equal(x, y) for x, y in zip(a, b)))
    return a == b


# The fine evaluation's card-against-CPU limit: the serve's position limit,
# 1e-2 m, in normalized cell units (make_scene's 30 m cells).
FINE_EVAL_LIMIT = 1e-2 / 30.0


def phase_train(dev, kernels, smi: str, others=(), absent=()) -> dict:
    """Both trainers at full width (f32 body, batch 32, 96 poses):
    train_coarse for one epoch (3 steps) with a validation split, one
    retrieval eval and a checkpoint; train_fine for 2 epochs of 3 steps
    with PMC tables (pmc_prob 0.5), eval_fine every epoch and checkpoints;
    then train_fine with 3 epochs resumed from the checkpoint directory
    (it continues after the last saved epoch: saves are gated on
    improvement). `kernels` must launch, `absent` must not; the launches of
    `others` are reported. The fine trainers' model and optimizer are
    copied to the host at each save, and the resume's restore is held
    against the copy of the last save. After the launches are read: the
    best checkpoint against the copy of its save and against the resumed
    run's returned best state (model, Adam, schedule bit for bit), a fresh
    state restored from it, the resumed run's gate, and eval_fine on the
    card against the CPU."""
    import dataclasses
    import tempfile

    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training import fine as fine_mod
    from text2loc_tpu_torch.training import steps as steps_lib
    from text2loc_tpu_torch.training.coarse import train_coarse
    from text2loc_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = _train_cfg(batch_size=32)
    cfg_f = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2, pmc_prob=0.5))
    data = _train_map(cfg, num_poses=96)
    data_pmc = MultiSceneArrays([_with_pmc(data.scenes[0], SEED + 7)])
    data_val = _val_map(cfg, num_poses=32)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    gen = torch.Generator().manual_seed(SEED + 2)
    coarse = init_weights(build_model(cfg, "coarse"), gen).to(dev)
    fine = init_weights(build_model(cfg, "fine"), gen).to(dev)
    resumed = init_weights(build_model(cfg, "fine"), gen).to(dev)
    before_c, before_f = _snapshot(coarse), _snapshot(fine)
    clones = []

    def counting_pmc(d, idx, rng, prob):
        cell_idx, hint_obj = sample_pmc(d, idx, rng, prob)
        clones.append(int((cell_idx != d.pose_cell_idx[idx]).sum()))
        return cell_idx, hint_obj

    # The fine trainer's own model (`trained[0]`) and optimizer (made by
    # make_fine_optimizer) copied to the host at each save that happens, and
    # whether the resume's restore gave them the last save's copy.
    trained, optimizers, saves, resume_restored = [fine], [], {}, []

    def recording_optimizer(*args, **kw):
        optimizers.append(make_fine_optimizer(*args, **kw))
        return optimizers[-1]

    def recording_save(self, step, state, metric):
        if self.mode == "min" and self._is_better(metric):
            saves[step] = _host_copy({"model": trained[0].state_dict(),
                                      "adam": optimizers[-1].adam.state_dict(),
                                      "schedule": optimizers[-1].schedule.state_dict()})
        return save(self, step, state, metric)

    def recording_restore(self, state_like=None, step=None):
        out = restore(self, state_like, step)
        if state_like is not None:
            resume_restored.append(
                _state_equal(_host_copy(state_like.state_dict()), saves[max(saves)]))
        return out

    sample_pmc, make_fine_optimizer = fine_mod.sample_pmc, steps_lib.make_fine_optimizer
    save, restore = CheckpointManager.save, CheckpointManager.restore
    workdir = tempfile.TemporaryDirectory(prefix="t2l_smoke_train_")
    try:
        fine_mod.sample_pmc = counting_pmc
        steps_lib.make_fine_optimizer = recording_optimizer
        CheckpointManager.save, CheckpointManager.restore = recording_save, recording_restore
        try:
            for k in (*kernels, *others, *absent):
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, _, clog = train_coarse(cfg, data, data_val, emb, workdir=workdir.name,
                                      device=dev, model=coarse)
            coarse_s = time.perf_counter() - t0
            coarse_peak = torch.cuda.max_memory_allocated()
            coarse_state = _check_trained(coarse, before_c, "coarse")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            best_state, _, flog = fine_mod.train_fine(cfg_f, data_pmc, data_val, emb,
                                                      workdir=workdir.name, device=dev,
                                                      model=fine)
            fine_s = time.perf_counter() - t0
            fine_peak = torch.cuda.max_memory_allocated()
            fine_state = _check_trained(fine, before_f, "fine")
            ckdir = f"{workdir.name}/fine_ckpt"
            before_resume = CheckpointManager(ckdir, mode="min")
            best_before, latest_before = before_resume.best_metric, before_resume.latest_step()
            cfg_r = cfg_f.replace(train=dataclasses.replace(cfg_f.train, epochs=3))
            trained[0] = resumed
            t0 = time.perf_counter()
            resumed_best, _, rlog = fine_mod.train_fine(cfg_r, data_pmc, data_val, emb,
                                                        workdir=workdir.name, resume=True,
                                                        device=dev, model=resumed)
            resume_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in (*kernels, *others, *absent)}
        finally:
            fine_mod.sample_pmc = sample_pmc
            steps_lib.make_fine_optimizer = make_fine_optimizer
            CheckpointManager.save, CheckpointManager.restore = save, restore

        # The round trip: the best checkpoint on disk holds the trainer's
        # model and optimizer as they were at its save, and the resumed
        # run's best state; a fresh model and optimizer restored from it
        # hold the same, bit for bit.
        mgr = CheckpointManager(ckdir, mode="min")
        saved_steps = sorted(os.listdir(ckdir))
        last_saved = saves[mgr.latest_step()]
        on_disk = mgr.restore()
        fresh = init_weights(build_model(cfg, "fine"), gen).to(dev)
        state = steps_lib.TrainState(fresh, steps_lib.make_fine_optimizer(
            fresh.parameters(), cfg, steps_per_epoch=3))
        t0 = time.perf_counter()
        mgr.restore(state)
        restore_s = time.perf_counter() - t0
        round_trip = {"file_equals_saved": _state_equal(on_disk, last_saved),
                      "file_equals_resumed_best": _state_equal(on_disk["model"],
                                                               resumed_best),
                      "restored_equals_saved": _state_equal(_host_copy(state.state_dict()),
                                                            last_saved),
                      "resume_restored_saved": resume_restored}
        adam_steps = {float(v["step"]) for v in on_disk["adam"]["state"].values()}
        schedule_pos = on_disk["schedule"]["last_epoch"]
        latest_after, best_after = mgr.latest_step(), mgr.best_metric
        with tempfile.TemporaryDirectory(prefix="t2l_smoke_ckpt_") as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CheckpointManager(d, mode="min").save(0, state, 1.0)
            save_s = time.perf_counter() - t0
    finally:
        workdir.cleanup()

    # eval_fine of the best fine state on the card and on the CPU ("first"
    # on both: the CPU runs its plain version), per pose and in the mean.
    fresh.load_state_dict(best_state)
    cpu_model = build_model(cfg, "fine")
    cpu_model.load_state_dict(best_state)
    fwd_card = steps_lib.make_fine_forward(fresh, emb, cfg)
    fwd_cpu = steps_lib.make_fine_forward(cpu_model, emb, cfg)
    batch = data_val.gather_fine(np.arange(data_val.num_poses), cfg.model.pad_size)
    pos_err = float((fwd_card(batch).cpu() - fwd_cpu(batch)).abs().max())
    err_card = fine_mod.eval_fine(data_val, fresh, emb, cfg, forward=fwd_card)
    err_cpu = fine_mod.eval_fine(data_val, cpu_model, emb, cfg, forward=fwd_cpu)
    eval_ms = cuda_ms(lambda: fine_mod.eval_fine(data_val, fresh, emb, cfg,
                                                 forward=fwd_card), reps=5)

    csteps, fsteps = clog.steps, flog.steps
    # The gate: each resumed epoch saves only when it beats the best so
    # far, which starts at the restored best.
    resumed_epochs = list(range(latest_before + 1, 3))
    best, last = best_before, latest_before
    for epoch, val in zip(resumed_epochs, rlog.history["val_pose_error"]):
        if val < best:
            best, last = val, epoch
    emit({"phase": "train", "card": smi, "config": "Config() f32 body",
          "poses": data.num_poses, "val_poses": data_val.num_poses,
          "batch": cfg.train.batch_size, "pad_size": cfg.model.pad_size,
          "coarse_steps": len(csteps),
          "coarse_step_ms": [h["seconds"] * 1e3 for h in csteps],
          "coarse_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in csteps),
          "coarse_losses": [h["loss"] for h in csteps],
          "coarse_val_acc": clog.history["val_acc"], "coarse_seconds": coarse_s,
          "coarse_peak_mem_gb": coarse_peak / 1e9, "coarse": coarse_state,
          "fine_steps": len(fsteps), "fine_step_ms": [h["seconds"] * 1e3 for h in fsteps],
          "fine_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in fsteps),
          "fine_losses": [h["loss"] for h in fsteps],
          "fine_pose_error": flog.history["pose_error"],
          "fine_val_pose_error": flog.history["val_pose_error"], "fine_seconds": fine_s,
          "pmc_clones_per_batch": clones, "fine_peak_mem_gb": fine_peak / 1e9,
          "fine": fine_state, "resume_seconds": resume_s,
          "resume_from_epoch": latest_before, "resume_best_before": best_before,
          "resume_epochs": rlog.epochs["loss"],
          "resume_val_pose_error": rlog.history["val_pose_error"],
          "checkpoint_steps": saved_steps,
          "checkpoint_round_trip_bit_equal": round_trip,
          "checkpoint_adam_steps": sorted(adam_steps), "checkpoint_schedule_pos": schedule_pos,
          "checkpoint_save_ms": save_s * 1e3, "checkpoint_restore_ms": restore_s * 1e3,
          "eval_fine_ms": eval_ms, "eval_fine_card": err_card, "eval_fine_cpu": err_cpu,
          "eval_fine_max_pos_err": pos_err, "eval_fine_limit": FINE_EVAL_LIMIT,
          "launches": counts})
    losses = [h["loss"] for h in csteps + fsteps + rlog.steps]
    check(len(csteps) == 3, f"train_coarse took {len(csteps)} steps, not 3")
    check(len(fsteps) == 6 and len(rlog.steps) == 3 * len(resumed_epochs),
          f"train_fine took {len(fsteps)} + {len(rlog.steps)} steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(coarse_state["sa_levels_with_grad"] == 3 and fine_state["sa_levels_with_grad"] == 3,
          "an SA level got no gradient")
    check(len(clog.history["val_acc"]) == 1 and len(flog.history["val_pose_error"]) == 2,
          "an evaluation during training did not run")
    check(sum(clones) > 0, f"no PMC clone in {clones}")
    check(list(rlog.epochs["loss"]) == resumed_epochs,
          f"the resumed run trained {rlog.epochs['loss']}, not {resumed_epochs}")
    check(all(v for k, v in round_trip.items() if k != "resume_restored_saved")
          and resume_restored == [True],
          f"the restored model / Adam / schedule state differs from the saved: {round_trip}")
    check(adam_steps == {3.0 * (latest_after + 1)} and schedule_pos == 3 * (latest_after + 1),
          f"the checkpoint of epoch {latest_after} holds Adam steps {adam_steps} and "
          f"schedule position {schedule_pos}, not {3 * (latest_after + 1)}")
    check(latest_after == last and best_after == best,
          f"the resumed saves ignored the restored best {best_before}: last saved "
          f"{latest_after} (expected {last}), best {best_after} (expected {best})")
    check(pos_err <= FINE_EVAL_LIMIT and abs(err_card - err_cpu) <= FINE_EVAL_LIMIT,
          f"eval_fine differs between the card and the CPU: {pos_err}, "
          f"{err_card} / {err_cpu}")
    check(all(counts[k.name] > 0 for k in kernels), f"a kernel never launched: {counts}")
    _check_absent(counts, absent, "train")
    return counts, {
        "coarse_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in csteps),
        "coarse_peak_mem_gb": coarse_peak / 1e9,
        "fine_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in fsteps),
        "fine_peak_mem_gb": fine_peak / 1e9}


def phase_train_optin(dev, kernels, f32_default: dict) -> dict:
    """3 train_coarse steps with a bf16 body and the tokens ("e","e","1"),
    then 2 fine steps with ("0","0","e") and vmem_gather=True, at full
    width, batch 32. The fine step's plain level 1 gathers rgb and xyz,
    which carry no gradient (gather_rows alone); its plain level 2 gathers
    level 1's output (gather_rows_grad: the scatter-add in the backward)."""
    import dataclasses

    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training import steps as steps_lib
    from text2loc_tpu_torch.training.coarse import train_coarse

    cfg = _train_cfg(batch_size=32)
    cfg_b = cfg.replace(model=dataclasses.replace(cfg.model, body_dtype="bfloat16"))
    data = _train_map(cfg, num_poses=96)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    gen = torch.Generator().manual_seed(SEED + 9)
    coarse_tokens, fine_tokens = ("e", "e", "1"), ("0", "0", "e")
    coarse = init_weights(build_model(cfg_b, "coarse", fused_train=coarse_tokens), gen).to(dev)
    fine = init_weights(build_model(cfg, "fine", fused_train=fine_tokens, vmem_gather=True),
                        gen).to(dev)
    before_c, before_f = _snapshot(coarse), _snapshot(fine)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, logger = train_coarse(cfg_b, data, None, emb, device=dev, model=coarse)
    history = logger.steps
    coarse_peak = torch.cuda.max_memory_allocated()
    coarse_state = _check_trained(coarse, before_c, "coarse optin")
    torch.cuda.reset_peak_memory_stats()
    opt = steps_lib.make_optimizer(fine.parameters(), cfg, steps_per_epoch=3)
    step = steps_lib.make_fine_train_step(fine, emb, cfg, opt,
                                          torch.Generator(device=dev).manual_seed(SEED))
    fine_hist = []
    for i in range(2):
        batch = data.gather_fine(np.arange(32 * i, 32 * (i + 1)), cfg.model.pad_size)
        t0 = time.perf_counter()
        m = step(batch)
        fine_hist.append({"loss": float(m["loss"]), "seconds": time.perf_counter() - t0})
    fine_peak = torch.cuda.max_memory_allocated()
    fine_state = _check_trained(fine, before_f, "fine optin")
    counts = {k.name: k.launches for k in kernels}
    losses = [h["loss"] for h in history] + [h["loss"] for h in fine_hist]
    emit({"phase": "train_optin", "coarse_body": "bfloat16", "coarse_tokens": coarse_tokens,
          "fine_tokens": fine_tokens, "fine_vmem_gather": True,
          "batch": cfg.train.batch_size,
          "coarse_step_ms": [h["seconds"] * 1e3 for h in history],
          "coarse_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in history),
          "coarse_peak_mem_gb": coarse_peak / 1e9, "coarse_losses": [h["loss"] for h in history],
          "coarse": coarse_state,
          "fine_step_ms": [h["seconds"] * 1e3 for h in fine_hist],
          "fine_median_step_ms": statistics.median(h["seconds"] * 1e3 for h in fine_hist),
          "fine_peak_mem_gb": fine_peak / 1e9, "fine_losses": [h["loss"] for h in fine_hist],
          "fine": fine_state, "f32_default": f32_default, "launches": counts})
    check(len(history) == 3, f"train_coarse took {len(history)} steps, not 3")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(coarse_state["sa_levels_with_grad"] == 3 and fine_state["sa_levels_with_grad"] == 3,
          "an SA level got no gradient")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    return counts


def _grad_report(got: dict, want: dict, rel_tol=1e-3, cos_tol=0.9999):
    """Per leaf: relative L2 error and cosine of the card's gradient against
    the CPU's, within rel_tol or cos_tol (rel_tol None: the cosine alone);
    leaves below 1e-6 x the global gradient norm (BN-shift and
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
        if not ((rel_tol is not None and rel <= rel_tol) or cos >= cos_tol):
            bad.append(k)
    return worst_rel, worst_cos, floor, bad


# The gradient criterion of the "e" card-vs-CPU step. The token rounds e =
# u[idx] - sv to bf16, so the f32 difference between the card's and the
# CPU's u flips the rounding of some elements, which moves neighbour-max
# winners at near-ties: on the CPU alone, noise of one f32 ulp in u moves
# the step's gradients by rel-L2 up to 0.064 and cosine down to 0.998
# (scripts/probe_torch_ecache_noise.py), where the f32 level stays within
# phase 9's rel 1e-3 / cos 0.9999. So each leaf is held by its cosine
# alone. A control shows that the limit still rejects a wrong path: the
# card's step with the f32 tokens ("e32") against the CPU's "e" step must
# have a leaf below it.
ECACHE_GRAD_COS = 0.99
ECACHE_CONTROL = ("e32", "e32", "e32")


def _coarse_step(cfg, emb, batch, fused_train, where):
    """(loss, gradient leaves, BN running statistics) of one coarse step
    from the seeded weights on `where`."""
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.training import steps as steps_lib

    model = init_weights(build_model(cfg, "coarse", fused_train=fused_train),
                         torch.Generator().manual_seed(SEED + 4)).to(where)
    opt = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch=1)
    step = steps_lib.make_coarse_train_step(
        model, emb, cfg, opt, torch.Generator(device=where).manual_seed(SEED))
    loss = float(step(batch)["loss"])
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items() if "running_" in k}
    return loss, grads, stats


def phase_train_vs_cpu(dev, fused_train=None, phase="train_vs_cpu", grad_cos=None,
                       control=None) -> None:
    """One coarse step on the card and on the CPU from the same weights,
    with the training SA tokens `fused_train` (None: the stage default);
    `grad_cos`: hold each gradient leaf by its cosine alone; `control`:
    tokens of a card step that the gradient criterion must reject against
    the CPU's step."""
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    cfg = _train_cfg(batch_size=8, plain=True)
    data = _train_map(cfg, num_poses=16)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    batch = data.gather_coarse(np.arange(8), cfg.model.object_size)
    (gl, gg, gs), (cl, cg, cs) = (_coarse_step(cfg, emb, batch, fused_train, w)
                                  for w in ("cuda", "cpu"))
    loss_rel = abs(gl - cl) / abs(cl)
    tols = (None, grad_cos) if grad_cos is not None else (1e-3, 0.9999)
    worst_rel, worst_cos, floor, bad = _grad_report(gg, cg, *tols)
    stat_rel = max(float((gs[k] - cs[k]).norm() / (cs[k].norm() + 1e-30)) for k in cs)
    report = {"phase": phase, "fused_train": fused_train, "batch": 8, "loss_cuda": gl,
              "loss_cpu": cl, "loss_rel_err": loss_rel, "grad_leaves": len(cg),
              "grad_floor": floor, "worst_grad_rel_l2": worst_rel, "worst_grad_cos": worst_cos,
              "grad_leaves_failed": bad, "worst_bn_stat_rel": stat_rel}
    if control is not None:
        _, xg, _ = _coarse_step(cfg, emb, batch, control, "cuda")
        x_rel, x_cos, _, x_bad = _grad_report(xg, cg, *tols)
        report.update({"control_fused_train": control, "control_worst_grad_rel_l2": x_rel,
                       "control_worst_grad_cos": x_cos, "control_leaves_failed": len(x_bad)})
    emit(report)
    check(set(gg) == set(cg), "gradient leaves differ between the card and the CPU")
    check(loss_rel <= 1e-4, f"loss differs by {loss_rel} (rel)")
    check(not bad, f"gradients differ between the card and the CPU: {bad[:5]}")
    check(stat_rel <= 1e-3, f"BN running statistics differ by {stat_rel} (rel)")
    if control is not None:
        check(bool(x_bad), f"the gradient criterion does not reject the control {control}")


# ----------------------------------------------------------------------- dp

DP_WORLD = 2
DP_TIMEOUT = 240      # seconds for the spawned ranks, their start-up included
DP_STEPS_TIMED = 3
# A DP step's gradient leaf against the step's without a mesh: its norm
# within this share. The leaf criterion of phase 9 holds a leaf by its
# cosine where its rel-L2 exceeds 1e-3, and a leaf scaled by the world
# size has a cosine of 1; by the triangle inequality the norm moves no
# more than the rel-L2, which phase 9's near-ties keep below this.
DP_LEAF_NORM_REL = 1e-2
# sa_train's statistics and parameter gradients at 2 ranks (summed over
# the ranks) against 1 rank, rel-L2 per tensor: only the order of the f32
# sums differs. The statistics are held to DP_SA_TRAIN_STATS_REL, the
# gradients to DP_SA_TRAIN_GRAD_REL: dgamma1 / dbeta1 are sums over the
# edges of dz W2^T, and dz sums to about 0 (BatchNorm's backward), so they
# cancel and carry the f32 noise of the order of the sums (about 1e-4
# on an H100); one rank with its clouds in another order (rolled by half)
# shows it beside. A gradient below 1e-6 x its level's gradient norm (db2, whose
# exact value is 0 by BatchNorm's shift invariance) only has to stay below
# 10 x that floor, phase 9's rule (_grad_report). Returning dgamma / dbeta
# reduced over the ranks (the control, _reduced_dgamma) puts them 1.0 off.
DP_SA_TRAIN_STATS_REL = 1e-5
DP_SA_TRAIN_GRAD_REL = 1e-3


def _dp_step(cfg, kind, batch, dev, mesh=None) -> dict:
    """One train step of `kind` from the seeded weights (SEED + 4) with the
    generator seeded SEED, on this rank's rows of `batch` under `mesh`:
    the loss, the gradient leaves and BN running statistics (on the host),
    the launches and collectives of that step, then the median ms of
    DP_STEPS_TIMED more steps."""
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.ops import cuda_fps, cuda_sa_train
    from text2loc_tpu_torch.parallel.mesh import shard_batch
    from text2loc_tpu_torch.parallel.train import (make_dp_coarse_train_step,
                                                   make_dp_fine_train_step, replicate_state)
    from text2loc_tpu_torch.training import steps as steps_lib

    model = init_weights(build_model(cfg, kind), torch.Generator().manual_seed(SEED + 4)).to(dev)
    make_opt = steps_lib.make_optimizer if kind == "coarse" else steps_lib.make_fine_optimizer
    opt = make_opt(model.parameters(), cfg, steps_per_epoch=1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb = _dp_embedder(cfg)
    out = {}
    if mesh is None:
        make = (steps_lib.make_coarse_train_step if kind == "coarse"
                else steps_lib.make_fine_train_step)
        step = make(model, emb, cfg, opt, gen)
    else:
        t0 = time.perf_counter()
        replicate_state(steps_lib.TrainState(model, opt), mesh)
        out["replicate_s"] = time.perf_counter() - t0
        make = make_dp_coarse_train_step if kind == "coarse" else make_dp_fine_train_step
        step = make(model, emb, cfg, opt, gen, mesh)
        batch = shard_batch(batch, mesh)
    kernels = (cuda_fps.KERNEL, cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD)
    for k in kernels:
        k.launches = 0
    calls = dict(mesh.calls) if mesh is not None else {}
    out["loss"] = float(step(batch)["loss"])
    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in kernels}
    out["collectives"] = ({k: v - calls.get(k, 0) for k, v in mesh.calls.items()}
                          if mesh is not None else {})
    out["grads"] = {k: p.grad.detach().to("cpu", copy=True)
                    for k, p in model.named_parameters() if p.grad is not None}
    out["stats"] = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()
                    if "running_" in k}
    times = []
    for _ in range(DP_STEPS_TIMED):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = statistics.median(times)
    out["all_launches"] = {k.name: k.launches for k in kernels}
    return out


def _dp_embedder(cfg):
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    return HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)


def _dp_batches(cfg) -> dict:
    data = _train_map(cfg, num_poses=96)
    b = cfg.train.batch_size
    return {"coarse": data.gather_coarse(np.arange(b), cfg.model.object_size),
            "fine": data.gather_fine(np.arange(b), cfg.model.pad_size)}


def _serve_cfg():
    import dataclasses

    from text2loc_tpu_torch.config import Config

    base = Config()
    return base.replace(model=dataclasses.replace(base.model, dtype="float32"))


def _serve_queries(data, n):
    q = np.arange(n) % data.num_poses
    return (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])


def _serve_ms(loc, data) -> float:
    args = _serve_queries(data, 8)
    loc.localize(*args)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        loc.localize(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


SA_TRAIN_LEVELS = [(256, 128, 32, 64, 0.2), (128, 64, 128, 128, 0.3), (64, 32, 256, 256, 0.4)]
SA_TRAIN_PARAMS = ("w2", "b2", "g1", "be1", "g2", "be2")


def _dp_sa_levels(dev, cells=32) -> list:
    """The coarse train step's three training SA levels at phase 8's batch
    (`cells` x 28 object clouds, a quarter padding, exact nearest-32
    neighbours of FPS centers: phase_sa_train_kernels' shapes at 32),
    drawn from SEED + 7: per level a dict of sa_train's inputs and a
    cotangent `dout`; the same on every rank."""
    from text2loc_tpu_torch.ops import cuda_fps
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    gen = torch.Generator().manual_seed(SEED + 7)
    n, k = cells * 28, 32
    pts = _clouds(gen, n, 256, dev)
    _, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    obj = (torch.arange(n, device=dev) % 28) < 21
    pos, levels = pts, []
    for p, s, h1, h2, radius in SA_TRAIN_LEVELS:
        ctr = xyz[:, :s].contiguous()
        idx, maskm = ball_query_knn(pos, ctr, radius, k)
        levels.append({
            "u": _rand(gen, (n, p, h1), 1.0, dev), "sv": _rand(gen, (n, s, h1), 0.5, dev),
            "w2": _rand(gen, (h1, h2), h1 ** -0.5, dev), "b2": _rand(gen, h2, 0.1, dev),
            "g1": _rand(gen, h1, 0.1, dev, 1.0), "be1": _rand(gen, h1, 0.1, dev),
            "g2": _rand(gen, h2, 0.1, dev, 1.0), "be2": _rand(gen, h2, 0.1, dev),
            "idx": idx.to(torch.int32).contiguous(), "maskm": maskm,
            "maskf": maskm & obj[:, None, None], "dout": _rand(gen, (n, s, h2), 1.0, dev)})
        pos = ctr
    return levels


def _dp_sa_ties(levels) -> list:
    """Per level, sa_train.near_ties at one rank's forward (bool [N, S, H2],
    on the host): the pairs whose gradient is not defined to within f32
    rounding (see SA_TRAIN_GRAD_FLOOR), where dout is zeroed."""
    from text2loc_tpu_torch.ops import cuda_sa_train, sa_train

    out = []
    for lv in levels:
        level = cuda_sa_train.Level(lv["u"], lv["sv"], lv["w2"], lv["idx"], lv["maskm"],
                                    lv["maskf"], torch.float32)
        _, _, aux1, aux2 = sa_train.forward_cuda(level, lv["b2"], lv["g1"], lv["be1"],
                                                 lv["g2"], lv["be2"], lv["maskf"], 1e-5)
        out.append(sa_train.near_ties(lv["u"], lv["sv"], lv["w2"], lv["idx"], lv["maskm"],
                                      aux1, aux2, torch.float32).cpu())
    return out


def _dp_sa_train(levels, ties, mesh=None, roll=0) -> list:
    """Per level, ops/sa_train.sa_train (the CUDA kernels, f32) on this
    rank's clouds under `mesh`: its statistics (mean1, var1, mean2, var2,
    count) and the parameters' gradients of sum(out * dout), dout zero at
    `ties`, summed over the ranks as the DP step sums them; on the host.
    `roll`: the clouds rolled by this many first (the same sums in another
    order)."""
    from text2loc_tpu_torch.ops.sa_train import sa_train
    from text2loc_tpu_torch.parallel.mesh import all_reduce_, shard_batch

    out = []
    for lv, tie in zip(levels, ties):
        clouds = {k: lv[k] for k in ("u", "sv", "idx", "maskm", "maskf")}
        clouds["dout"] = lv["dout"].masked_fill(tie.to(lv["dout"].device), 0.0)
        clouds = {k: torch.roll(v, roll, 0) for k, v in clouds.items()}
        if mesh is not None:
            clouds = shard_batch(clouds, mesh)
        params = [lv[k].clone().requires_grad_() for k in SA_TRAIN_PARAMS]
        y, stats = sa_train(clouds["u"], clouds["sv"], *params, clouds["idx"], clouds["maskm"],
                            clouds["maskf"], mesh=mesh)
        (y * clouds["dout"]).sum().backward()
        grads = [p.grad for p in params]
        if mesh is not None:
            grads = [all_reduce_(g.clone(), mesh) for g in grads]
        out.append({"stats": [s.detach().cpu() for s in stats],
                    "dparams": [g.detach().cpu() for g in grads]})
    return out


def _reduced_dgamma(backward):
    """`backward` (sa_train.backward_cuda) returning dgamma / dbeta summed
    over the ranks: the double count under the gradient all-reduce that
    the comparison must reject (a control)."""
    from text2loc_tpu_torch.parallel.mesh import global_sums

    def wrapped(level, aux1, aux2, n1, dout, mesh=None):
        grads = list(backward(level, aux1, aux2, n1, dout, mesh))
        grads[4:] = global_sums(mesh, *grads[4:])
        return tuple(grads)

    return wrapped


def _dp_sa_errs(got, want) -> dict:
    """rel-L2 of each level's statistics and parameter gradients against
    one rank's: {"stats": worst, "dparams": worst, per name: worst,
    "zero_failed": [(level, name) of gradients below the floor (see
    DP_SA_TRAIN_STATS_REL) that did not stay below 10 x it]}."""
    errs = {"stats": 0.0, "dparams": 0.0, **{k: 0.0 for k in SA_TRAIN_PARAMS},
            "zero_failed": []}
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g["stats"], w["stats"]):
            e = float((a.double() - b.double()).norm() / (b.double().norm() + 1e-30))
            errs["stats"] = max(errs["stats"], e)
        floor = 1e-6 * float(torch.sqrt(sum(b.double().pow(2).sum() for b in w["dparams"])))
        for name, a, b in zip(SA_TRAIN_PARAMS, g["dparams"], w["dparams"]):
            if float(b.norm()) < floor:
                if not float(a.norm()) < 10 * floor:
                    errs["zero_failed"].append((i, name))
                continue
            e = float((a.double() - b.double()).norm() / b.double().norm())
            errs[name] = max(errs[name], e)
            errs["dparams"] = max(errs["dparams"], e)
    return errs


def _dp_rank(mesh, sa_ties) -> dict:
    """What each spawned rank of phase dp runs (gloo, cuda:0): the DP coarse
    and fine steps on half the batch, then the sharded serve (f32,
    Config() width) over phase 4's map, then sa_train alone at the coarse
    step's levels on half the clouds, and again with the control backward
    (_reduced_dgamma). Rank 0 returns the gradients."""
    from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_mha, cuda_pointconv,
                                        cuda_sa_train)
    from text2loc_tpu_torch.serving import Localizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cfg = _train_cfg(batch_size=32)
    out = {}
    for kind, batch in _dp_batches(cfg).items():
        r = _dp_step(cfg, kind, batch, dev, mesh)
        if mesh.rank != 0:
            r.pop("grads"), r.pop("stats")
        out[kind] = r
    serve_kernels = (cuda_fps.KERNEL, cuda_pointconv.KERNEL_FIRST, cuda_mha.KERNEL,
                     cuda_mha.KERNEL_TILED, cuda_ffn.KERNEL, cuda_sa_train.KERNEL_FWD,
                     cuda_sa_train.KERNEL_BWD)
    for k in serve_kernels:
        k.launches = 0
    scfg = _serve_cfg()
    data = _map(2, 32, scfg)
    coarse, fine = _models(scfg, torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    loc = Localizer(data, coarse, fine, _dp_embedder(scfg), scfg, top_k=10, mesh=mesh)
    torch.cuda.synchronize()
    out["serve"] = {"build_s": time.perf_counter() - t0, "rows": int(loc.gallery.shape[0]),
                    "result": loc.localize(*_serve_queries(data, 64)),
                    "ms_batch8": _serve_ms(loc, data),
                    "launches": {k.name: k.launches for k in serve_kernels}}
    out.update(_dp_sa_rank(mesh, sa_ties))
    return out


def _dp_sa_rank(mesh, sa_ties, cells=32) -> dict:
    """Part (d) on one rank: _dp_sa_train over its half of the clouds, and
    again with the control backward (_reduced_dgamma)."""
    from text2loc_tpu_torch.ops import sa_train

    levels = _dp_sa_levels(mesh.device, cells)
    out = {"sa_train": _dp_sa_train(levels, sa_ties, mesh)}
    backward = sa_train.backward_cuda
    sa_train.backward_cuda = _reduced_dgamma(backward)
    try:
        out["sa_train_control"] = _dp_sa_train(levels, sa_ties, mesh)
    finally:
        sa_train.backward_cuda = backward
    return out


def _leaf_norms(got: dict, want: dict, floor: float):
    """(worst |(|g| / |w|) - 1| over the leaves above `floor`, the leaves
    beyond DP_LEAF_NORM_REL)."""
    worst, bad = 0.0, []
    for k, w in want.items():
        nw = float(w.double().norm())
        if nw < floor:
            continue
        dev = abs(float(got[k].double().norm()) / nw - 1.0)
        worst = max(worst, dev)
        if not dev <= DP_LEAF_NORM_REL:
            bad.append(k)
    return worst, bad


def _dp_compare(report, name, got, want, tag) -> list:
    """Phase 9's criteria for one DP step against the step without a mesh:
    loss rel 1e-4, each gradient leaf rel-L2 1e-3 or cosine 0.9999 (above
    the floor), BN running statistics rel 1e-4; and each leaf's norm within
    DP_LEAF_NORM_REL of the step's without a mesh, which a leaf counted on
    every rank (the cosine of a scaled leaf is 1) fails. Returns the
    failures."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    worst_rel, worst_cos, floor, bad = _grad_report(got["grads"], want["grads"])
    worst_norm, bad_norm = _leaf_norms(got["grads"], want["grads"], floor)
    stat_rel = max(float((got["stats"][k] - v).norm() / (v.norm() + 1e-30))
                   for k, v in want["stats"].items())
    report[name] = {"loss": got["loss"], "loss_rel_err": loss_rel,
                    "worst_grad_rel_l2": worst_rel, "worst_grad_cos": worst_cos,
                    "grad_leaves_failed": bad, "worst_leaf_norm_rel": worst_norm,
                    "leaf_norms_failed": bad_norm, "worst_bn_stat_rel": stat_rel,
                    "ms_per_step": got["ms"], "launches_per_step": got["launches"],
                    "collectives_per_step": got["collectives"]}
    fails = []
    if set(got["grads"]) != set(want["grads"]):
        fails.append(f"{tag}: gradient leaves differ")
    if not loss_rel <= 1e-4:
        fails.append(f"{tag}: loss differs by {loss_rel} (rel)")
    if bad:
        fails.append(f"{tag}: gradients differ: {bad[:5]}")
    if bad_norm:
        fails.append(f"{tag}: gradient norms differ: {bad_norm[:5]}")
    if not stat_rel <= 1e-4:
        fails.append(f"{tag}: BN running statistics differ by {stat_rel} (rel)")
    return fails


def phase_dp(dev, smi: str) -> dict:
    """Data parallelism on the card (phase 8's training shapes: f32 body,
    batch 32, the training SA kernels on): (a) world 1 on NCCL in this
    process, a DP coarse and fine step against the same steps without a
    mesh; (b) world 2 on gloo, two spawned ranks on cuda:0 with half the
    batch each, the same comparison, sa_train_fwd and sa_train_bwd launched
    on every rank, each gradient leaf's norm within DP_LEAF_NORM_REL; (c)
    the sharded serve at world 2 (f32, Config() width, phase 4's map)
    against the dense serve: top-1 equal (rows whose dense top-1/top-2
    margin exceeds 1e-4, phase 5's rule; every row's agreement is
    reported), positions within 1e-4 m; (d) sa_train alone (the card's
    hand-derived backward) at the coarse step's three levels, world 2
    against one rank: statistics and parameter gradients summed over the
    ranks within DP_SA_TRAIN_STATS_REL / DP_SA_TRAIN_GRAD_REL, and the
    control that returns dgamma / dbeta reduced over the ranks rejected.
    Returns the phase's launches (every rank's; (d) launches for its
    comparison and counts none)."""
    import tempfile

    import torch.distributed as dist

    from text2loc_tpu_torch.dryrun import run_ranks
    from text2loc_tpu_torch.ops import cuda_sa_train
    from text2loc_tpu_torch.parallel.mesh import make_mesh
    from text2loc_tpu_torch.serving import Localizer

    t_phase = time.perf_counter()
    cfg = _train_cfg(batch_size=32)
    batches = _dp_batches(cfg)
    want = {kind: _dp_step(cfg, kind, batch, dev) for kind, batch in batches.items()}
    report = {"phase": "dp", "nvidia_smi": smi, "batch": cfg.train.batch_size,
              "ms_per_step_no_mesh": {k: v["ms"] for k, v in want.items()}}
    fails, launches = [], {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="t2l_smoke_dp_") as tmp:
        mesh = make_mesh(1, device=dev, backend="nccl", init_method=f"file://{tmp}/store",
                         rank=0, world_size=1)
        try:
            world1 = {kind: _dp_step(cfg, kind, batch, dev, mesh)
                      for kind, batch in batches.items()}
        finally:
            dist.destroy_process_group()
    for kind in batches:
        fails += _dp_compare(report, f"nccl_world1_{kind}", world1[kind], want[kind],
                             f"world 1 {kind}")
        add(world1[kind]["all_launches"])

    sa_levels = _dp_sa_levels(dev)
    sa_ties = _dp_sa_ties(sa_levels)
    sa_want = _dp_sa_train(sa_levels, sa_ties)
    half = sa_levels[0]["u"].shape[0] // 2
    sa_rolled = _dp_sa_errs(_dp_sa_train(sa_levels, sa_ties, roll=half), sa_want)
    del sa_levels
    t0 = time.perf_counter()
    ranks = run_ranks(_dp_rank, DP_WORLD, args=(sa_ties,), timeout=DP_TIMEOUT,
                      backend="gloo", device=dev)
    report["world2_ranks_s"] = time.perf_counter() - t0
    sa_report = {"levels": [f"P={p} S={s} H={h1}->{h2}" for p, s, h1, h2, _ in SA_TRAIN_LEVELS],
                 "near_ties": [int(t.sum()) for t in sa_ties],
                 "limits": {"stats": DP_SA_TRAIN_STATS_REL, "dparams": DP_SA_TRAIN_GRAD_REL},
                 "one_rank_rolled_rel_l2": sa_rolled}
    for rank, r in enumerate(ranks):
        errs = _dp_sa_errs(r["sa_train"], sa_want)
        ctrl = _dp_sa_errs(r["sa_train_control"], sa_want)
        sa_report[f"rank{rank}"] = {"rel_l2": errs, "control_rel_l2": ctrl}
        if not (errs["stats"] <= DP_SA_TRAIN_STATS_REL
                and errs["dparams"] <= DP_SA_TRAIN_GRAD_REL and not errs["zero_failed"]):
            fails.append(f"sa_train world 2 rank {rank}: statistics {errs['stats']}, "
                         f"parameter gradients {errs['dparams']} (rel) from one rank, "
                         f"zero gradients not held: {errs['zero_failed']}")
        if not all(ctrl[k] > DP_SA_TRAIN_GRAD_REL for k in ("g1", "be1", "g2", "be2")):
            fails.append(f"sa_train world 2 rank {rank}: the comparison does not reject "
                         f"dgamma / dbeta reduced over the ranks: {ctrl}")
    report["sa_train_world2"] = sa_report
    for kind in batches:
        fails += _dp_compare(report, f"gloo_world2_{kind}", ranks[0][kind], want[kind],
                             f"world 2 {kind}")
        per_rank = [r[kind] for r in ranks]
        report[f"gloo_world2_{kind}"].update(
            ms_per_step_per_rank=[r["ms"] for r in per_rank],
            launches_per_step_per_rank=[r["launches"] for r in per_rank],
            replicate_s_per_rank=[r["replicate_s"] for r in per_rank])
        for rank, r in enumerate(per_rank):
            add(r["all_launches"])
            if r["loss"] != per_rank[0]["loss"]:
                fails.append(f"world 2 {kind}: rank {rank} reports another loss")
            for k in (cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD):
                if not r["launches"][k.name] > 0:
                    fails.append(f"world 2 {kind}: rank {rank} launched no {k.name}")

    scfg = _serve_cfg()
    data = _map(2, 32, scfg)
    coarse, fine = _models(scfg, torch.Generator().manual_seed(SEED))
    dense = Localizer(data, coarse, fine, _dp_embedder(scfg), scfg, top_k=10, device=dev)
    want_res = dense.localize(*_serve_queries(data, 64))
    serve = {"dense_ms_batch8": _serve_ms(dense, data), "queries": 64,
             "cells": data.num_cells}
    for rank, r in enumerate(ranks):
        got = r["serve"]["result"]
        compared, top1_equal, pos_err = _top1_agreement(got, want_res)
        serve[f"rank{rank}"] = {
            "rows_held": r["serve"]["rows"], "build_s": r["serve"]["build_s"],
            "ms_batch8": r["serve"]["ms_batch8"], "launches": r["serve"]["launches"],
            "compared": compared, "top1_equal": top1_equal, "max_pos_err_m": pos_err,
            "top1_equal_all_rows": bool((got.cell_indices[:, 0]
                                         == want_res.cell_indices[:, 0]).all()),
            "max_score_err": float(np.abs(got.scores - want_res.scores).max())}
        add(r["serve"]["launches"])
        if not (top1_equal and pos_err <= 1e-4):
            fails.append(f"sharded serve rank {rank}: top-1 {top1_equal}, positions "
                         f"{pos_err} m from the dense serve")
    report["serve_world2"] = serve
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    check(not fails, "; ".join(fails))
    return launches


# -------------------------------------------------------------- serve paths

KITTI_SCENE = "2013_05_28_drive_0010_sync"   # the val split's one scene


def _write_kitti_scene(base: str, name: str, seed: int, grid: int = 4,
                       num_poses: int = 48) -> None:
    """One scene of the published schema under `base`: grid x grid 30 m
    cells of 8-14 objects (64-599 points each), `num_poses` poses of six
    hints (every third unmatched), pickled under the reference's module path
    as the published pickles are, and the compass neighbour map in
    direction/<name>.json."""
    from text2loc_tpu_torch import constants as C
    from text2loc_tpu_torch.data import structs as S

    rng = np.random.default_rng(seed)
    labels = [c for c in C.CLASS_TO_INDEX if c != "pad"]
    cells = []
    for i in range(grid * grid):
        x, y = 30.0 * (i % grid), 30.0 * (i // grid)
        objs = []
        for j in range(int(rng.integers(8, 15))):
            n = int(rng.integers(64, 600))
            objs.append(S.Object3d(j, 1000 * i + j, rng.random((n, 3)).astype(np.float32),
                                   rng.random((n, 3)).astype(np.float32),
                                   labels[int(rng.integers(len(labels)))]))
        cells.append(S.Cell(i, name, objs, 30.0, np.array([x, y, 0.0, x + 30, y + 30, 30])))
    poses = []
    for _ in range(num_poses):
        cell = cells[int(rng.integers(len(cells)))]
        pose_in_cell = rng.uniform(0.1, 0.9, 2)
        pose3 = np.r_[pose_in_cell, 0.0]
        descrs = []
        for s in range(6):
            obj = cell.objects[int(rng.integers(len(cell.objects)))]
            d = S.DescriptionPoseCell()
            d.object_id, d.object_instance_id, d.object_label = obj.id, obj.instance_id, obj.label
            d.object_color_rgb, d.object_color_text = obj.get_color_rgb(), obj.get_color_text()
            d.direction = C.DIRECTIONS[int(rng.integers(C.NUM_DIRECTIONS))]
            closest = obj.get_closest_point(pose3)
            d.offset_center = (pose3 - obj.get_center())[:2]
            d.offset_closest = (pose3 - closest)[:2]
            d.closest_point = closest[:2]
            descrs.append(S.DescriptionBestCell.unmatched(d) if s % 3 == 2 else
                          S.DescriptionBestCell.matched(d, obj.id, closest, d.offset_center,
                                                        d.offset_closest))
        poses.append(S.Pose(pose_in_cell, cell.bbox_w[:3] + np.r_[pose_in_cell * 30.0, 0.0],
                            cell.id, name, descrs))
    for kind, obj in (("cells", cells), ("poses", poses)):
        os.makedirs(os.path.join(base, kind), exist_ok=True)
        S.dump_compat_pickle(obj, os.path.join(base, kind, f"{name}.pkl"))
    neighbors = {}
    for i, cell in enumerate(cells):
        gx, gy = i % grid, i // grid
        neighbors[cell.id] = {
            key: (cells[(gy + dy) * grid + gx + dx].id
                  if 0 <= gx + dx < grid and 0 <= gy + dy < grid else None)
            for key, (dx, dy) in zip(C.NEIGHBOR_KEYS, _COMPASS)}
    os.makedirs(os.path.join(base, "direction"), exist_ok=True)
    with open(os.path.join(base, "direction", f"{name}.json"), "w") as f:
        json.dump(neighbors, f)


def _median_ms(fn, reps: int = 10) -> float:
    """Median host milliseconds of fn() (a serve call, which ends in a copy
    to the host), after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _same_result(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _http(addr, path, payload=None):
    import urllib.request

    host, port = addr
    req = urllib.request.Request(
        f"http://{host}:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _http_phase(loc, data, report) -> None:
    """64 POSTs from 8 threads, hint triples and descriptions in turn,
    through LocalizationServer over a BatchingFrontend: each answer against
    the direct single-query localize (top-1 where the margin exceeds 1e-4,
    positions within 1e-2 m), client latency p50 / p99, and the mean group
    size from /stats."""
    import threading

    from text2loc_tpu_torch.serving import LocalizationResult
    from text2loc_tpu_torch.serving_frontend import BatchingFrontend
    from text2loc_tpu_torch.serving_http import LocalizationServer
    from text2loc_tpu_torch.text import render_description

    n, threads = 64, 8
    poses = np.arange(n) % data.num_poses
    latency, answers, errors = [0.0] * n, [None] * n, []
    with LocalizationServer(BatchingFrontend(loc, max_batch=16, max_wait_s=0.002),
                            port=0) as srv:
        check(_http(srv.address, "/healthz") == (200, {"ok": True}), "/healthz")

        def client(t):
            try:
                for i in range(t, n, threads):
                    p = poses[i]
                    payload = ({"hints": {"dir": data.hint_dir[p].tolist(),
                                          "color": data.hint_color[p].tolist(),
                                          "label": data.hint_label[p].tolist(),
                                          "mask": data.hint_mask[p].tolist()}}
                               if i % 2 == 0 else
                               {"description": render_description(
                                   data.hint_dir[p], data.hint_color[p],
                                   data.hint_label[p], data.hint_mask[p])})
                    t0 = time.perf_counter()
                    status, out = _http(srv.address, "/localize", payload)
                    latency[i] = (time.perf_counter() - t0) * 1e3
                    check(status == 200, f"POST /localize: {status} {out}")
                    answers[i] = out
            except Exception as e:  # noqa: BLE001  every client's failure is reported
                errors.append(repr(e))

        workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(300)
        check(not any(w.is_alive() for w in workers), "an HTTP client hung")
        check(not errors, f"HTTP clients failed: {errors[:3]}")
        _, stats = _http(srv.address, "/stats")
    got = LocalizationResult(
        position_w=np.array([a["position"] for a in answers], np.float32),
        candidates_w=np.array([a["candidates"] for a in answers], np.float32),
        cell_indices=np.array([a["cells"] for a in answers]),
        scores=np.array([a["scores"] for a in answers], np.float32))
    solo = [loc.localize(data.hint_dir[p:p + 1], data.hint_color[p:p + 1],
                         data.hint_label[p:p + 1], data.hint_mask[p:p + 1]) for p in poses]
    want = LocalizationResult(*(np.concatenate([getattr(r, f) for r in solo])
                                for f in LocalizationResult._fields))
    compared, top1_equal, pos_err = _top1_agreement(got, want)
    report["http"] = {
        "requests": n, "threads": threads, "p50_ms": float(np.percentile(latency, 50)),
        "p99_ms": float(np.percentile(latency, 99)),
        "mean_group_size": stats["mean_group_size"], "dispatches": stats["dispatches"],
        "compared": compared, "top1_equal": top1_equal, "max_pos_err_m": pos_err,
        "bit_equal": int(sum(np.array_equal(got.candidates_w[i], want.candidates_w[i])
                             and np.array_equal(got.cell_indices[i], want.cell_indices[i])
                             for i in range(n)))}
    check(stats["requests"] == n, f"/stats counts {stats['requests']} requests")
    check(top1_equal and pos_err <= 1e-2,
          f"HTTP answers differ from localize: {report['http']}")


def phase_serve_paths(dev, kernels, smi: str, absent=()) -> tuple:
    """Serving a real-schema map: ingest, the persisted cache, the stepwise,
    embedded and text paths and the HTTP server, at Config() width (bf16)
    with seeded random weights. Returns the phase's launches and the
    ingested scene."""
    import dataclasses
    import tempfile
    from unittest import mock

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.data import ingest
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.ops import cuda_fps, cuda_pointconv
    from text2loc_tpu_torch.serving import Localizer
    from text2loc_tpu_torch.text import render_description

    t_phase = time.perf_counter()
    cfg = Config()
    report = {"phase": "serve_paths", "card": smi, "config": "Config() bf16"}
    for k in (*kernels, *absent):
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # 1. Ingest, then the same conversion from the npz cache alone.
        base, arrays = os.path.join(tmp, "kitti360pose"), os.path.join(tmp, "arrays")
        _write_kitti_scene(base, KITTI_SCENE, SEED + 14)
        t = time.perf_counter()
        data = ingest.load_dataset(base, "val", out_dir=arrays)
        report["ingest_s"] = time.perf_counter() - t
        with mock.patch.object(ingest, "load_compat_pickle",
                               side_effect=AssertionError("read a pickle")):
            t = time.perf_counter()
            again = ingest.load_dataset(base, "val", out_dir=arrays)
            report["ingest_from_npz_s"] = time.perf_counter() - t
        scene = data.scenes[0]
        check(data.num_cells == 16 and data.num_poses == 48,
              f"ingested {data.num_cells} cells, {data.num_poses} poses")
        check(scene.pmc_valid is not None and scene.cell_neighbors is not None,
              "the ingested scene has no PMC tables")
        for f in dataclasses.fields(scene):
            a, b = getattr(scene, f.name), getattr(again.scenes[0], f.name)
            check(a == b if isinstance(a, (str, list)) else np.array_equal(a, b),
                  f"ingest from the npz cache differs in {f.name}")
        report["pmc_valid_pairs"] = int(scene.pmc_valid.sum())

        # 2. The cache round trip.
        coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 14))
        emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                             cfg.model.max_hint_tokens)
        cache = os.path.join(tmp, "gallery.npz")

        def make(path=cache, **kw):
            t = time.perf_counter()
            loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev,
                            cache_path=path, **kw)
            torch.cuda.synchronize()
            return loc, time.perf_counter() - t

        loc, report["build_s"] = make()
        pointnet = (cuda_fps.KERNEL, cuda_pointconv.KERNEL_FIRST)
        before = [k.launches for k in pointnet]
        warm, report["build_from_cache_s"] = make()
        t = time.perf_counter()
        warm._cache_digest()
        report["digest_s"] = time.perf_counter() - t
        check([k.launches for k in pointnet] == before,
              "the build from the cache launched a PointNet kernel")

        def hints(b):
            q = np.arange(b) % data.num_poses
            return data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q]

        cached8 = loc.localize(*hints(8))
        _check_result(cached8, data, 8, loc.top_k)
        check(_same_result(warm.localize(*hints(8)), cached8),
              "the build from the cache serves other results")
        with np.load(cache, allow_pickle=False) as f:
            stale = {k: f[k] for k in f.files}
        stale["digest"] = np.asarray("0" * 64)
        bad = os.path.join(tmp, "stale.npz")
        with open(bad, "wb") as fh:
            np.savez(fh, **stale)
        try:
            make(bad)
            refused = False
        except ValueError:
            refused = True
        check(refused, "a cache file with another digest was accepted")

        # 3. The stepwise path, its kernels launched by the queries alone.
        step, report["build_stepwise_from_cache_s"] = make(precompute_fine=False)
        check(step.fine_emb is None, "the stepwise Localizer holds a fine cache")
        latency, per_call = {}, {}

        def launched(name, fn):
            """fn(), with its launches of the path's kernels in per_call."""
            before = {k.name: k.launches for k in kernels}
            out = fn()
            per_call[name] = {k.name: k.launches - before[k.name] for k in kernels}
            return out

        report["stepwise"] = {}
        for b in (1, 8):
            got = launched(f"stepwise_{b}", lambda b=b: step.localize(*hints(b)))
            want = launched(f"cached_{b}", lambda b=b: loc.localize(*hints(b)))
            _check_result(got, data, b, step.top_k)
            compared, top1_equal, pos_err = _top1_agreement(got, want)
            report["stepwise"][str(b)] = {"compared": compared, "top1_equal": top1_equal,
                                          "max_pos_err_m": pos_err}
            check(top1_equal and pos_err <= 1e-2,
                  f"stepwise batch {b} differs from the cached serve: "
                  f"{report['stepwise'][str(b)]}")
        stepwise = {k.name: per_call["stepwise_1"][k.name] + per_call["stepwise_8"][k.name]
                    for k in kernels}
        check(all(v > 0 for v in stepwise.values()),
              f"a kernel never launched in the stepwise queries: {stepwise}")

        # 4. The embedded and the text paths.
        text = emb.to(dev).embed(*hints(8))
        embedded = tuple(t.cpu().numpy() for t in text)
        got = launched("embedded_8", lambda: loc.localize_embedded(*embedded))
        compared, top1_equal, pos_err = _top1_agreement(got, cached8)
        report["embedded"] = {"compared": compared, "top1_equal": top1_equal,
                              "max_pos_err_m": pos_err}
        check(top1_equal and pos_err <= 1e-2,
              f"localize_embedded differs from localize: {report['embedded']}")
        descs = [render_description(*(a[i] for a in hints(8))) for i in range(8)]
        check(_same_result(launched("text_8", lambda: loc.localize_text(descs)), cached8),
              "localize_text of rendered descriptions differs from localize")
        for b in (1, 8):
            latency[f"cached_{b}"] = _median_ms(lambda b=b: loc.localize(*hints(b)))
            latency[f"stepwise_{b}"] = _median_ms(lambda b=b: step.localize(*hints(b)))
        latency["embedded_8"] = _median_ms(lambda: loc.localize_embedded(*embedded))
        latency["text_8"] = _median_ms(lambda: loc.localize_text(descs))
        report["median_ms_per_batch"] = latency
        report["launches_per_call"] = per_call

        # 5. HTTP.
        _http_phase(loc, data, report)
    counts = {k.name: k.launches for k in (*kernels, *absent)}
    report["launches"] = counts
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    check(all(counts[k.name] > 0 for k in kernels), f"a kernel never launched: {counts}")
    _check_absent(counts, absent, "serve_paths")
    return counts, data



# ------------------------------------------------------------------ T5 text

# huggingface.co/t5-large config.json: the encoder's published widths.
T5_LARGE = dict(vocab_size=32128, d_model=1024, d_kv=64, num_heads=16, d_ff=4096,
                num_layers=24, feed_forward_proj="relu",
                relative_attention_num_buckets=32, relative_attention_max_distance=128)
T5_CPU_LAYERS = 2      # the card-vs-CPU encoder: the same weights cut to two layers
T5_CPU_LIMIT = 1e-3    # its largest absolute embedding difference, f32
# The cut in bf16: its largest absolute difference from the CPU's bf16
# forward within this many bf16 spacings at the largest |CPU output|, the
# bound tests/test_torch_port_t5.py holds the CPU forward to against JAX.
T5_BF16_SPACINGS = 2


def t5_state_dict(widths: dict, seed: int) -> dict:
    """A T5 encoder's HF state dict (HF key names) at `widths`, seeded with
    numpy at HF's initialisation scales (T5PreTrainedModel._init_weights,
    factor 1): embedding std 1; q (d_model·d_kv)^-0.5; k, v d_model^-0.5; o
    (heads·d_kv)^-0.5; wi d_model^-0.5; wo d_ff^-0.5; the relative bias
    d_model^-0.5; norms 1. scripts/profile_torch_t5.py builds its encoder
    from it too."""
    rng = np.random.default_rng(seed)
    d, dkv, h, ff = widths["d_model"], widths["d_kv"], widths["num_heads"], widths["d_ff"]
    inner = h * dkv

    def normal(shape, std):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(std)
        return torch.from_numpy(a)

    emb = normal((widths["vocab_size"], d), 1.0)
    sd = {"shared.weight": emb, "encoder.embed_tokens.weight": emb}
    for i in range(widths["num_layers"]):
        a, f = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        sd[f"{a}.SelfAttention.q.weight"] = normal((inner, d), (d * dkv) ** -0.5)
        sd[f"{a}.SelfAttention.k.weight"] = normal((inner, d), d ** -0.5)
        sd[f"{a}.SelfAttention.v.weight"] = normal((inner, d), d ** -0.5)
        sd[f"{a}.SelfAttention.o.weight"] = normal((d, inner), inner ** -0.5)
        if i == 0:
            sd[f"{a}.SelfAttention.relative_attention_bias.weight"] = normal(
                (widths["relative_attention_num_buckets"], h), d ** -0.5)
        sd[f"{a}.layer_norm.weight"] = torch.ones(d)
        sd[f"{f}.DenseReluDense.wi.weight"] = normal((ff, d), d ** -0.5)
        sd[f"{f}.DenseReluDense.wo.weight"] = normal((d, ff), ff ** -0.5)
        sd[f"{f}.layer_norm.weight"] = torch.ones(d)
    sd["encoder.final_layer_norm.weight"] = torch.ones(d)
    return sd


def _write_t5_snapshot(path: str, sd: dict, widths: dict) -> None:
    """An HF snapshot directory: pytorch_model.bin, config.json and the
    vendored tiny tokenizer's files."""
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    _write_t5_config_and_tokenizer(path, widths)


def _write_t5_config_and_tokenizer(path: str, widths: dict) -> None:
    """A snapshot's config.json and the vendored tiny tokenizer's files."""
    import shutil

    from text2loc_tpu_torch.assets import tiny_t5_tokenizer_path

    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "t5", "architectures": ["T5EncoderModel"], **widths,
                   "num_decoder_layers": 0, "layer_norm_epsilon": 1e-6,
                   "dropout_rate": 0.0}, f)
    src = tiny_t5_tokenizer_path()
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), path)


class _CountingEncoder:
    """An online encoder that counts its encode calls."""

    def __init__(self, inner):
        self.inner, self.calls, self.embed_dim = inner, 0, inner.embed_dim

    def encode(self, sentences):
        self.calls += 1
        return self.inner.encode(sentences)


def phase_t5_text(dev, kernels, smi: str, data, absent=()) -> dict:
    """The online T5 text path over phase 14's ingested scene: a T5-large
    encoder (seeded random weights, the vendored tokenizer) loaded from a
    written snapshot, its two-layer cut card against CPU in f32, encode
    times, localize_text of styled and canonical descriptions, the f32
    card-vs-CPU localize_text through the two-layer cut, and
    eval_styled_retrieval through the compositional stand-in and through
    T5. Returns the phase's launches."""
    import dataclasses
    import tempfile

    from text2loc_tpu_torch import text_styles
    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.styled import (eval_styled_retrieval,
                                                      render_canonical_queries,
                                                      render_styled_queries)
    from text2loc_tpu_torch.models import t5_encoder as T5
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    t_phase = time.perf_counter()
    cfg = Config()
    tokens = cfg.model.max_hint_tokens
    widths = T5_LARGE
    check(widths["d_model"] == cfg.model.text_embed_dim,
          "the T5 width differs from the table's text_embed_dim")
    report = {"phase": "t5_text", "card": smi, "t5": widths, "max_tokens": tokens,
              "config": "Config() bf16"}
    for k in (*kernels, *absent):
        k.launches = 0

    # 1. The snapshot, written and loaded.
    t = time.perf_counter()
    sd = t5_state_dict(widths, SEED + 15)
    with tempfile.TemporaryDirectory() as tmp:
        _write_t5_snapshot(tmp, sd, widths)
        report["snapshot_write_s"] = time.perf_counter() - t
        t = time.perf_counter()
        full = T5.T5OnlineEncoder.from_snapshot(tmp, max_tokens=tokens, device=dev)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        full_bf16 = T5.T5OnlineEncoder.from_snapshot(tmp, max_tokens=tokens,
                                                     dtype="bfloat16", device=dev)
        torch.cuda.synchronize()
        report["load_bf16_s"] = time.perf_counter() - t
    check(full.cfg == T5.T5Config(**widths), f"the snapshot loaded as {full.cfg}")
    check(full_bf16.cfg == T5.T5Config(**widths, dtype="bfloat16"),
          f"the bf16 snapshot loaded as {full_bf16.cfg}")
    check(full.model.token_embed.device.type == torch.device(dev).type,
          "the encoder's weights are not on the card")

    # 2. The two-layer cut, card against CPU, f32.
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 products")
    cut = {k: v.numpy() for k, v in sd.items()
           if not k.startswith("encoder.block.")
           or int(k.split(".")[2]) < T5_CPU_LAYERS}
    del sd
    params, cut_cfg = T5.convert_t5_encoder(cut, widths["relative_attention_max_distance"])
    small = {"cuda": T5.T5OnlineEncoder(params, cut_cfg, full.tokenizer, tokens, device=dev),
             "cpu": T5.T5OnlineEncoder(params, cut_cfg, full.tokenizer, tokens, device="cpu")}
    cut_bf16 = dataclasses.replace(cut_cfg, dtype="bfloat16")
    small_bf16 = {w: T5.T5OnlineEncoder(params, cut_bf16, full.tokenizer, tokens, device=d)
                  for w, d in (("cuda", dev), ("cpu", "cpu"))}
    del cut, params
    rng = np.random.default_rng(SEED + 15)
    poses = np.arange(8)
    sentences = [text_styles.render_styled_hint(data.hint_dir[p, s], data.hint_color[p, s],
                                                data.hint_label[p, s], rng)
                 for p in poses for s in range(data.hint_dir.shape[1])]
    check(len(sentences) == 48, f"{len(sentences)} styled sentences")
    (e_card, m_card), (e_cpu, m_cpu) = (small[w].encode(sentences) for w in ("cuda", "cpu"))
    err = float(np.abs(e_card - e_cpu).max())
    report["card_vs_cpu"] = {"layers": T5_CPU_LAYERS, "sentences": len(sentences),
                             "max_abs_err": err, "limit": T5_CPU_LIMIT,
                             "real_tokens": int(m_cpu.sum())}
    check(np.array_equal(m_card, m_cpu), "the card's token mask differs from the CPU's")
    check(err <= T5_CPU_LIMIT, f"T5 card vs CPU: {err} > {T5_CPU_LIMIT}")

    # The same cut in bf16, card against CPU.
    (b_card, bm_card), (b_cpu, bm_cpu) = (small_bf16[w].encode(sentences)
                                          for w in ("cuda", "cpu"))
    peak = float(np.abs(b_cpu).max())
    limit = T5_BF16_SPACINGS * 2.0 ** (np.floor(np.log2(peak)) - 7)
    diff = np.abs(b_card - b_cpu)
    report["card_vs_cpu_bf16"] = {"layers": T5_CPU_LAYERS, "sentences": len(sentences),
                                  "max_abs_err": float(diff.max()), "limit": float(limit),
                                  "spacings": T5_BF16_SPACINGS, "max_abs_cpu": peak,
                                  "mean_abs_err": float(diff.mean())}
    check(np.array_equal(bm_card, bm_cpu), "bf16: the card's token mask differs from the CPU's")
    check(bool(np.isfinite(b_card).all()) and float(diff.max()) <= limit,
          f"T5 bf16 card vs CPU: {report['card_vs_cpu_bf16']}")
    del small_bf16

    # The f32 localize_text through the two-layer cut, card against CPU.
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, tokens)
    styled = render_styled_queries(data, np.random.default_rng(SEED + 16), poses)
    canonical = render_canonical_queries(data, poses)
    check(all(a != b for a, b in zip(styled, canonical)), "a styled description is canonical")
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    f32 = {}
    for where, device in (("cuda", dev), ("cpu", "cpu")):
        c32, fine32 = _models(cfg32, torch.Generator().manual_seed(SEED + 15))
        f32[where] = Localizer(data, c32, fine32, emb, cfg32, top_k=5, device=device,
                               online_encoder=small[where]).localize_text(styled)
    compared, top1_equal, pos_err = _top1_agreement(f32["cuda"], f32["cpu"])
    report["localize_text_vs_cpu"] = {
        "compared": compared, "top1_equal": top1_equal, "max_pos_err_m": pos_err,
        "max_score_err": float(np.abs(f32["cuda"].scores - f32["cpu"].scores).max())}
    check(top1_equal and pos_err <= 1e-2,
          f"f32 localize_text differs between the card and the CPU: "
          f"{report['localize_text_vs_cpu']}")
    del small, f32
    torch.cuda.empty_cache()

    # 3. The full encoder on the card.
    torch.cuda.reset_peak_memory_stats()
    encode_ms = {str(n): _median_ms(lambda n=n: full.encode(sentences[:n])) for n in (48, 8)}
    report["encode_ms"] = encode_ms
    report["tokens_per_s"] = {n: int(n) * tokens / (ms / 1e3) for n, ms in encode_ms.items()}
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # The full encoder in bf16 (24 layers), beside the f32 figures.
    e_bf16, _ = full_bf16.encode(sentences)
    check(e_bf16.shape == (48, tokens, widths["d_model"]) and bool(np.isfinite(e_bf16).all()),
          f"the bf16 encoder: shape {e_bf16.shape} or non-finite values")
    report["encode_ms_bf16"] = {str(n): _median_ms(lambda n=n: full_bf16.encode(sentences[:n]))
                                for n in (48, 8)}
    del full_bf16

    # 4. localize_text at Config() width with the full encoder.
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 14))
    counting = _CountingEncoder(full)
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev,
                    online_encoder=counting)
    before = {k.name: k.launches for k in kernels}
    got = loc.localize_text(styled)
    report["launches_per_call"] = {k.name: k.launches - before[k.name] for k in kernels}
    check(counting.calls == 1, f"{counting.calls} T5 calls for one styled batch")
    _check_result(got, data, len(poses), loc.top_k)
    report["styled_top1"] = float(np.mean(got.cell_indices[:, 0] == data.pose_cell_idx[poses]))
    report["localize_text_ms"] = _median_ms(lambda: loc.localize_text(styled))
    calls = counting.calls
    table = loc.localize_text(canonical)
    check(counting.calls == calls, "canonical descriptions went through T5")
    check(_same_result(table, loc.localize(data.hint_dir[poses], data.hint_color[poses],
                                           data.hint_label[poses], data.hint_mask[poses])),
          "localize_text of canonical descriptions differs from localize")
    report["canonical_ms"] = _median_ms(lambda: loc.localize_text(canonical))

    # 5. eval_styled_retrieval through each online encoder.
    report["styled_eval"] = {}
    for name, enc in (("compositional",
                       T5.CompositionalOnlineEncoder(cfg.model.text_embed_dim, tokens)),
                      ("t5", full)):
        loc.online_encoder = enc
        t = time.perf_counter()
        out = eval_styled_retrieval(loc, data, seed=SEED, top_k=cfg.eval.top_k)
        report["styled_eval"][name] = {
            "styled_recall": out["styled"]["recall"],
            "canonical_recall": out["canonical"]["recall"],
            "styled_mean_error_m": out["styled"]["mean_error_m"],
            "seconds": time.perf_counter() - t}
    counts = {k.name: k.launches for k in (*kernels, *absent)}
    report["launches"] = counts
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    check(all(counts[k.name] > 0 for k in kernels), f"a kernel never launched: {counts}")
    _check_absent(counts, absent, "t5_text")
    return counts


# ------------------------------------------------------- readers and tables

T5_HUB_ID = "t2l-smoke/t5-large-seeded"


def _write_safetensors(path: str, tensors: dict) -> int:
    """A .safetensors file of f32 `tensors` (the format's 8-byte header
    length, JSON header, raw little-endian data); returns its data bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().float().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return offset


def _charsmap_script():
    """scripts/build_precompiled_charsmap.py of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "build_precompiled_charsmap.py")
    spec = importlib.util.spec_from_file_location("build_precompiled_charsmap", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_hub_snapshot(cache: str, sd: dict, widths: dict) -> str:
    """The two-layer T5 of `sd` as the hub cache holds a model id: refs/main
    naming a snapshot of three safetensors shards and their index (the
    tied embedding kept once, as shared.weight), config.json, and the
    vendored tokenizer rewritten to t5-large's layout: a Sequence of
    Precompiled (scripts/build_precompiled_charsmap.py's charsmap) and
    Replace, WhitespaceSplit then Metaspace. Returns the snapshot path."""
    repo = os.path.join(cache, "models--" + T5_HUB_ID.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", "0" * 40)
    os.makedirs(snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write("0" * 40)
    names = [k for k in sd if k != "encoder.embed_tokens.weight"]
    shards = [["shared.weight"], [k for k in names if k.startswith("encoder.block.0.")],
              [k for k in names if k != "shared.weight"
               and not k.startswith("encoder.block.0.")]]
    weight_map, total = {}, 0
    for i, keys in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += _write_safetensors(os.path.join(snap, fname), {k: sd[k] for k in keys})
        weight_map.update({k: fname for k in keys})
    with open(os.path.join(snap, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    _write_t5_config_and_tokenizer(snap, widths)
    with open(os.path.join(snap, "tokenizer.json")) as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": _charsmap_script().charsmap_base64()},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}
    with open(os.path.join(snap, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    return snap


def _t5_front_door(dev, data) -> dict:
    """Phase 15's T5-large-width seeded encoder cut to its two card-vs-CPU
    layers, loaded by model id from a sharded hub-cache snapshot with a
    Precompiled tokenizer and from an unsharded directory with the vendored
    one: phase 15's styled localize_text batch of 8 through each gives the
    same top-1 and positions within 1e-4 m."""
    import tempfile

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.styled import render_styled_queries
    from text2loc_tpu_torch.models import t5_encoder as T5
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    cfg = Config()
    tokens = cfg.model.max_hint_tokens
    widths = dict(T5_LARGE, num_layers=T5_CPU_LAYERS)
    sd = t5_state_dict(widths, SEED + 15)
    out = {"layers": T5_CPU_LAYERS, "model_id": T5_HUB_ID}
    old = os.environ.get("HF_HUB_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        snap = _write_hub_snapshot(os.path.join(tmp, "hub"), sd, widths)
        out["write_s"] = time.perf_counter() - t
        plain = os.path.join(tmp, "plain")
        os.makedirs(plain)
        _write_t5_snapshot(plain, sd, widths)
        del sd
        try:
            os.environ["HF_HUB_CACHE"] = os.path.join(tmp, "hub")
            check(T5.resolve_snapshot(T5_HUB_ID) == snap, "the model id resolved elsewhere")
            t = time.perf_counter()
            by_id = T5.T5OnlineEncoder.from_snapshot(T5_HUB_ID, max_tokens=tokens, device=dev)
            torch.cuda.synchronize()
            out["load_by_id_s"] = time.perf_counter() - t
        finally:
            if old is None:
                os.environ.pop("HF_HUB_CACHE", None)
            else:
                os.environ["HF_HUB_CACHE"] = old
        t = time.perf_counter()
        by_dir = T5.T5OnlineEncoder.from_snapshot(plain, max_tokens=tokens, device=dev)
        torch.cuda.synchronize()
        out["load_dir_s"] = time.perf_counter() - t
    check(by_id.tokenizer.normalizer is not None, "the Precompiled normalizer was not read")
    poses = np.arange(8)
    styled = render_styled_queries(data, np.random.default_rng(SEED + 16), poses)
    ids = [by_id.tokenizer.encode(s, tokens) for s in styled]
    check(ids == [by_dir.tokenizer.encode(s, tokens) for s in styled],
          "the Precompiled tokenizer's ids differ from the vendored tokenizer's")
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, tokens)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 14))
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev, online_encoder=by_dir)
    want = loc.localize_text(styled)
    loc.online_encoder = by_id
    got = loc.localize_text(styled)
    compared, top1_equal, pos_err = _top1_agreement(got, want)
    out.update(compared=compared, top1_equal=top1_equal, max_pos_err_m=pos_err,
               all_top1_equal=bool((got.cell_indices[:, 0] == want.cell_indices[:, 0]).all()))
    check(top1_equal and out["all_top1_equal"] and pos_err <= 1e-4,
          f"the model-id load serves otherwise than the directory load: {out}")
    return out


def _tables_vs_cpu(dev, tables, kernels) -> dict:
    """Coarse and fine models with the embedding `tables` on, f32 at
    Config() width over an 8-cell map: the cached, stepwise, embedded and
    text serve paths and run_pipeline on the card and on the CPU, by
    phase_serve_vs_cpu's and phase_pipeline_vs_cpu's limits, and the
    launches of each path on the card."""
    import dataclasses

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline
    from text2loc_tpu_torch.evaluation.styled import render_styled_queries
    from text2loc_tpu_torch.models.t5_encoder import CompositionalOnlineEncoder
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    base = Config()
    cfg = base.replace(model=dataclasses.replace(
        base.model, dtype="float32", **{f"{t}_embed": True for t in tables}))
    m = cfg.model
    data = _map(1, 8, cfg)
    emb = HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)
    online = CompositionalOnlineEncoder(m.text_embed_dim, m.max_hint_tokens)
    q = np.arange(8)
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    text = emb.embed(*args)
    embedded = (text.token_embeds.numpy(), text.token_mask.numpy(),
                text.sentence_mask.numpy())
    styled = render_styled_queries(data, np.random.default_rng(SEED + 20), q)
    launches, results = {}, {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else "cpu"
        coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 20))
        res = results[where] = {}

        def run(path, fn):
            for k in kernels:
                k.launches = 0
            out = fn()
            if where == "cuda":
                torch.cuda.synchronize()
                launches[path] = {k.name: k.launches for k in kernels}
            return out

        loc = run("build", lambda: Localizer(data, coarse, fine, emb, cfg, top_k=5,
                                             device=device, online_encoder=online))
        res["cached"] = run("cached", lambda: loc.localize(*args))
        res["embedded"] = run("embedded", lambda: loc.localize_embedded(*embedded))
        res["text"] = run("text", lambda: loc.localize_text(styled))
        step = Localizer(data, coarse, fine, emb, cfg, top_k=3, device=device,
                         precompute_fine=False)
        res["stepwise"] = run("stepwise", lambda: step.localize(*args))
        res["pipeline"] = run("pipeline", lambda: run_pipeline(
            data, coarse, fine, emb, cfg, device=device, verbose=False))
        if where == "cpu":
            sure = _retrieval_margin(data, coarse, emb, cfg) > 1e-4
    report = {"tables": list(tables), "cells": data.num_cells, "queries": len(q),
              "launches": launches}
    for path in ("cached", "stepwise", "embedded", "text"):
        compared, top1_equal, pos_err = _top1_agreement(results["cuda"][path],
                                                        results["cpu"][path])
        report[path] = {"compared": compared, "top1_equal": top1_equal,
                        "max_pos_err_m": pos_err}
        check(compared > 0 and top1_equal and pos_err <= 1e-2,
              f"{tables} {path}: the card differs from the CPU: {report[path]}")
    got, want = results["cuda"]["pipeline"], results["cpu"]["pipeline"]
    same = got["retrievals"] == want["retrievals"]
    dpos = np.abs(got["pos_in_cells"] - want["pos_in_cells"])[same]
    dpos = dpos * data.cell_size[want["retrievals"]][same][:, None]
    report["pipeline"] = {
        "compared": int(sure.sum()),
        "top1_equal": bool((got["retrievals"][sure, 0] == want["retrievals"][sure, 0]).all()),
        "max_pos_err_m": float(dpos.max()) if dpos.size else float("inf")}
    check(report["pipeline"]["compared"] > 0 and report["pipeline"]["top1_equal"]
          and report["pipeline"]["max_pos_err_m"] <= 1e-2,
          f"{tables} run_pipeline: the card differs from the CPU: {report['pipeline']}")
    return report


def phase_readers_tables(dev, kernels, smi: str, data) -> dict:
    """This slice's paths at full Config() width: (a) the T5 front door by
    model id from a sharded hub-cache snapshot with a Precompiled
    tokenizer; (b) coarse and fine models with class_embed and color_embed
    (no PointNet: no FPS or SA kernel may launch); (c) color_embed alone
    (PointNet and its kernels run). Returns the phase's launches."""
    from text2loc_tpu_torch.ops import cuda_ffn, cuda_fps, cuda_mha, cuda_pointconv

    t_phase = time.perf_counter()
    report = {"phase": "readers_tables", "card": smi,
              "t5_front_door": _t5_front_door(dev, data)}
    point = [cuda_fps.KERNEL.name] + [k.name for k in cuda_pointconv.KERNELS]
    totals = {k.name: 0 for k in kernels}
    for name, tables in (("class_color", ("class", "color")), ("color", ("color",))):
        r = report[name] = _tables_vs_cpu(dev, tables, kernels)
        summed = {k.name: sum(c[k.name] for c in r["launches"].values()) for k in kernels}
        for k in totals:
            totals[k] += summed[k]
        check(summed[cuda_mha.KERNEL.name] > 0 and summed[cuda_ffn.KERNEL.name] > 0,
              f"{name}: the attention or feed-forward kernel never launched: {summed}")
        if "class" in tables:
            check(all(summed[k] == 0 for k in point),
                  f"{name}: a PointNet kernel launched without a PointNet: {summed}")
        else:
            check(summed[cuda_fps.KERNEL.name] > 0
                  and summed[cuda_pointconv.KERNEL_FIRST.name] > 0,
                  f"{name}: PointNet's kernels never launched: {summed}")
    report["launches"] = totals
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    return totals


# ---------------------------------------------------------- prep and serve

PREP_SCENE = "2013_05_28_drive_0000_sync"
PREP_WINDOWS = 4                 # static windows of the raw scene
PREP_WINDOW_POINTS = 1_050_000   # raw points a window
PREP_LENGTH_M = 400.0            # the trajectory (a KITTI-360 drive runs for kilometres)
PREP_OVERLAP_M = 10.0            # windows overlap by this much at each end
# KITTI-360 semantic ids; "car" is no class of the dataset: the prep drops it.
_SEM = dict(road=7, sidewalk=8, building=11, pole=17, vegetation=21, terrain=22, car=26)
# Share of a window's points by class.
_SHARE = dict(road=0.20, sidewalk=0.14, terrain=0.14, vegetation=0.24, building=0.20,
              pole=0.02, car=0.06)


def _write_ply(path: str, xyz, rgb, semantic, instance) -> None:
    """A binary little-endian PLY of KITTI-360's static windows: float x, y,
    z, uchar red, green, blue, int semantic, instance."""
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                   ("green", "u1"), ("blue", "u1"), ("semantic", "<i4"), ("instance", "<i4")])
    rec = np.empty(len(xyz), dt)
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["red"], rec["green"], rec["blue"] = rgb.T
    rec["semantic"], rec["instance"] = semantic, instance
    ply_type = {"<f4": "float", "u1": "uchar", "<i4": "int"}
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(xyz)}\n"
              + "".join(f"property {ply_type[dt[n].str.replace('|', '')]} {n}\n"
                        for n in dt.names)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def _road_y(x):
    return 3.0 * np.sin(x / 60.0)


def _window_points(w: int, seed: int, points: int):
    """One static window of the synthetic drive: x over the window's stretch
    of road (with the overlap), and along it road, sidewalks and terrain
    (stuff sheets), trees (vegetation), buildings and poles (instances) and
    cars."""
    rng = np.random.default_rng([seed, w])
    step = PREP_LENGTH_M / PREP_WINDOWS
    x0, x1 = w * step - PREP_OVERLAP_M, (w + 1) * step + PREP_OVERLAP_M
    parts = []

    def emit_part(name, xyz, iid, colour):
        n = len(xyz)
        rgb = np.clip(np.asarray(colour) + rng.normal(0, 18, (n, 3)), 0, 255).astype(np.uint8)
        parts.append((xyz.astype(np.float32), rgb, np.full(n, _SEM[name], np.int32),
                      np.full(n, iid, np.int32)))

    def sheet(name, lo, hi, z0, zs, colour):
        n = int(points * _SHARE[name])
        x = rng.uniform(x0, x1, n)
        dy = rng.uniform(lo, hi, n) * rng.choice((-1.0, 1.0), n) if lo > 0 else rng.uniform(-hi, hi, n)
        emit_part(name, np.column_stack([x, _road_y(x) + dy, z0 + rng.normal(0, zs, n)]),
                  _SEM[name] * 1000, colour)

    sheet("road", 0.0, 3.5, 0.0, 0.03, (90, 90, 95))
    sheet("sidewalk", 3.5, 5.5, 0.15, 0.02, (160, 150, 140))
    sheet("terrain", 5.5, 8.5, 0.0, 0.1, (120, 110, 60))

    def along(every, offset):
        """Objects at x = every * k + offset on both sides, inside the window."""
        ks = np.arange(np.ceil((x0 - offset) / every), np.floor((x1 - offset) / every) + 1)
        return [(int(k), side, every * k + offset) for k in ks for side in (0, 1)]

    trees = along(7.0, 3.5)
    n = int(points * _SHARE["vegetation"])
    pick = rng.integers(len(trees), size=n)
    cx = np.array([t[2] for t in trees])[pick]
    cy = _road_y(cx) + np.where(np.array([t[1] for t in trees])[pick] == 0, 10.0, -10.0)
    emit_part("vegetation", np.column_stack([cx, cy, np.full(n, 3.0)])
              + rng.normal(0, 1, (n, 3)) * [1.2, 1.2, 1.0], _SEM["vegetation"] * 1000,
              (60, 110, 50))

    def per_object(name, objects, shape, colour):
        n = int(points * _SHARE[name]) // max(len(objects), 1)
        for k, side, x in objects:
            centre = np.array([x, _road_y(x) + shape["dy"] * (1 if side == 0 else -1), 0.0])
            emit_part(name, centre + shape["points"](n, k), _SEM[name] * 1000 + 2 * k + side,
                      colour)

    def facades(n, k):
        h = 8.0 + 2.0 * (k % 4)
        u = rng.uniform(-1, 1, (n, 2))
        wall = rng.integers(4, size=n)
        x = np.where(wall < 2, np.where(wall == 0, -4.0, 4.0), 4.0 * u[:, 0])
        y = np.where(wall >= 2, np.where(wall == 2, -3.0, 3.0), 3.0 * u[:, 1])
        return np.column_stack([x, y, rng.uniform(0, h, n)]) + rng.normal(0, 0.02, (n, 3))

    per_object("building", along(12.0, 6.0), dict(dy=13.5, points=facades), (170, 120, 100))
    per_object("pole", along(9.0, 4.5), dict(dy=5.0, points=lambda n, k: np.column_stack(
        [rng.normal(0, 0.08, n), rng.normal(0, 0.08, n), rng.uniform(0, 6.0, n)])), (80, 80, 80))
    per_object("car", along(20.0, 10.0), dict(dy=2.0, points=lambda n, k: rng.normal(
        0, 1, (n, 3)) * [2.0, 0.8, 0.6] + [0, 0, 0.8]), (30, 40, 150))
    return [np.concatenate(c) for c in zip(*parts)], (x0, x1)


def _write_raw_scene(base: str, seed: int, windows=range(PREP_WINDOWS),
                     points: int = PREP_WINDOW_POINTS) -> int:
    """The synthetic drive in KITTI-360's raw layout under `base`:
    data_3d_semantics/<scene>/static/<first>_<last>.ply per window and
    data_poses/<scene>/poses.txt (a pose a metre along the windows'
    stretch). Returns the raw points written."""
    static = os.path.join(base, "data_3d_semantics", PREP_SCENE, "static")
    os.makedirs(static)
    total, lo, hi = 0, np.inf, -np.inf
    for w in windows:
        cols, (x0, x1) = _window_points(w, seed, points)
        _write_ply(os.path.join(static, f"{w * 1000:010d}_{w * 1000 + 999:010d}.ply"), *cols)
        total += len(cols[0])
        lo, hi = min(lo, max(x0, 0.0)), max(hi, min(x1, PREP_LENGTH_M))
    x = np.arange(lo, hi + 1e-9, 1.0)
    rows = [np.r_[i, np.hstack([np.eye(3), [[xi], [_road_y(xi)], [1.7]]]).ravel()]
            for i, xi in enumerate(x)]
    os.makedirs(os.path.join(base, "data_poses", PREP_SCENE))
    np.savetxt(os.path.join(base, "data_poses", PREP_SCENE, "poses.txt"), np.array(rows))
    return total


def _same_graph(got, want, where="") -> None:
    """Equal object graphs: the same classes, equal attributes, arrays equal
    with equal dtypes."""
    if isinstance(want, (list, tuple)):
        check(isinstance(got, (list, tuple)) and len(got) == len(want), f"{where}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_graph(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        check(isinstance(got, dict) and sorted(got) == sorted(want), f"{where}: keys")
        for k in want:
            _same_graph(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        check(isinstance(got, np.ndarray) and got.dtype == want.dtype
              and got.shape == want.shape and np.array_equal(got, want), f"{where}: array")
    elif hasattr(want, "__dict__"):
        check(type(got) is type(want), f"{where}: class")
        _same_graph(vars(got), vars(want), where)
    else:
        check(type(got) is type(want) and got == want, f"{where}: {got!r} != {want!r}")


def _prepare(raw: str, out: str, device: str) -> dict:
    """The port's prep CLI at its defaults on `device`: its stage seconds
    and counts."""
    import contextlib
    import io

    from text2loc_tpu_torch.prep import prepare

    argv = ["--path_in", raw, "--path_out", os.path.join(out, "data"), "--scene_name",
            PREP_SCENE, "--array_dir", os.path.join(out, "arrays"), "--device", device]
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = prepare.main(argv)
    stats["seconds"] = time.perf_counter() - t
    return stats


def _prepared(out: str, raw: str) -> dict:
    from text2loc_tpu_torch.data.structs import load_compat_pickle

    data = os.path.join(out, "data")
    with open(os.path.join(data, "direction", f"{PREP_SCENE}.json")) as f:
        direction = json.load(f)
    with np.load(os.path.join(out, "arrays", f"{PREP_SCENE}.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return {"objects": load_compat_pickle(os.path.join(raw, "objects", f"{PREP_SCENE}.pkl")),
            "cells": load_compat_pickle(os.path.join(data, "cells", f"{PREP_SCENE}.pkl")),
            "poses": load_compat_pickle(os.path.join(data, "poses", f"{PREP_SCENE}.pkl")),
            "direction": direction, "arrays": arrays}


def phase_prep_serve(dev, kernels, smi: str, absent=()) -> dict:
    """From a raw KITTI-360 scene to a served map inside the port: the prep
    CLI on the card at its defaults over a synthetic 4-window drive, the
    card's prep against the CPU's on a cut of one window (every output
    equal), then the prepared map served at Config() width (bf16): a batch
    of 8 requests and the launches of the serve kernels, and the f32 serve
    on the card against the CPU over the same map (phase 5's criteria).
    Returns the phase's launches."""
    import shutil
    import tempfile

    from text2loc_tpu_torch.config import Config
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays, SceneArrays
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.serving import Localizer

    t_phase = time.perf_counter()
    report = {"phase": "prep_serve", "card": smi}
    for k in (*kernels, *absent):
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        raw_points = _write_raw_scene(os.path.join(tmp, "raw"), SEED + 17)
        cut_points = _write_raw_scene(os.path.join(tmp, "cut_cuda"), SEED + 17, windows=(0,))
        shutil.copytree(os.path.join(tmp, "cut_cuda"), os.path.join(tmp, "cut_cpu"))
        report["write_raw_s"] = time.perf_counter() - t

        # 1. The whole scene on the card.
        full = _prepare(os.path.join(tmp, "raw"), os.path.join(tmp, "out"), "cuda")
        report["scene"] = {"raw_points": raw_points, **full}
        check(full["windows"] == PREP_WINDOWS and raw_points >= PREP_WINDOWS * 1_000_000,
              f"the raw scene: {full['windows']} windows, {raw_points} points")
        check(full["cells"] >= 30 and full["poses"] >= 100,
              f"prepared {full['cells']} cells and {full['poses']} poses")

        # 2. The cut: the card's prep against the CPU's, every output equal.
        cut = {where: _prepare(os.path.join(tmp, f"cut_{where}"),
                               os.path.join(tmp, f"cut_out_{where}"), where)
               for where in ("cuda", "cpu")}
        report["cut"] = {"raw_points": cut_points, "card": cut["cuda"], "cpu": cut["cpu"]}
        check(cut["cuda"]["cells"] > 0 and cut["cuda"]["poses"] > 0, f"the cut: {cut['cuda']}")
        got, want = (_prepared(os.path.join(tmp, f"cut_out_{w}"), os.path.join(tmp, f"cut_{w}"))
                     for w in ("cuda", "cpu"))
        for key in want:
            _same_graph(got[key], want[key], f"cut {key}: the card against the CPU")

        # 3. The prepared map served on the card.
        data = MultiSceneArrays([SceneArrays.load_npz(
            os.path.join(tmp, "out", "arrays", f"{PREP_SCENE}.npz"))])
    cfg = Config()
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)
    hints = _serve_queries(data, 8)
    coarse, fine = _models(cfg, torch.Generator().manual_seed(SEED + 17))
    t = time.perf_counter()
    loc = Localizer(data, coarse, fine, emb, cfg, top_k=10, device=dev)
    torch.cuda.synchronize()
    report["serve_build_s"] = time.perf_counter() - t
    _check_result(loc.localize(*hints), data, 8, loc.top_k)
    report["serve_ms_batch8"] = _median_ms(lambda: loc.localize(*hints))
    counts = {k.name: k.launches for k in (*kernels, *absent)}
    report["launches"] = counts

    # 4. The f32 serve, card against CPU, over the same map.
    cfg32 = _serve_cfg()
    results = {}
    for where in ("cuda", "cpu"):
        coarse, fine = _models(cfg32, torch.Generator().manual_seed(SEED + 17))
        results[where] = Localizer(data, coarse, fine, emb, cfg32, top_k=5,
                                   device=dev if where == "cuda" else "cpu").localize(*hints)
    compared, top1_equal, pos_err = _top1_agreement(results["cuda"], results["cpu"])
    report["serve_vs_cpu"] = {"compared": compared, "top1_equal": top1_equal,
                              "max_pos_err_m": pos_err}
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    check(all(counts[k.name] > 0 for k in kernels), f"a kernel never launched: {counts}")
    _check_absent(counts, absent, "prep_serve")
    check(top1_equal and pos_err <= 1e-2,
          f"the prepared map's f32 serve: the card differs from the CPU: {report['serve_vs_cpu']}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 2
    from text2loc_tpu_torch.ops import (cuda_ffn, cuda_fps, cuda_gather, cuda_ln, cuda_mha,
                                        cuda_pointconv, cuda_sa_train, cuda_split)

    optin = [cuda_ln.KERNEL, cuda_gather.KERNEL, cuda_ffn.KERNEL_TILED]
    serve_kernels = [cuda_fps.KERNEL, cuda_pointconv.KERNEL_FIRST, cuda_mha.KERNEL,
                     cuda_mha.KERNEL_TILED, cuda_ffn.KERNEL]
    train_kernels = [cuda_fps.KERNEL, cuda_sa_train.KERNEL_FWD, cuda_sa_train.KERNEL_BWD,
                     cuda_pointconv.KERNEL_FIRST, cuda_mha.KERNEL, cuda_ffn.KERNEL]
    pipeline_kernels = [cuda_fps.KERNEL, *cuda_pointconv.KERNELS, cuda_mha.KERNEL,
                        cuda_mha.KERNEL_TILED, cuda_ffn.KERNEL]
    train_optin_kernels = [cuda_fps.KERNEL, cuda_sa_train.KERNEL_FWD,
                           cuda_sa_train.KERNEL_BWD, cuda_sa_train.KERNEL_E_FWD, cuda_sa_train.KERNEL_E_BWD,
                           cuda_gather.KERNEL, cuda_gather.KERNEL_SCATTER]
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    records.update(phase_sa_train_kernels(dev))
    records.update(phase_optin_kernels(dev))
    counts = [phase_serve(dev, serve_kernels, absent=optin)]
    counts.append(phase_trace(dev, serve_kernels + optin, smi))
    phase_serve_vs_cpu(dev)
    counts.append(phase_layers(dev, [cuda_ln.KERNEL, cuda_mha.KERNEL_TILED,
                                     cuda_ffn.KERNEL_TILED, cuda_mha.KERNEL, cuda_ffn.KERNEL,
                                     cuda_split.KERNEL]))
    counts.append(phase_pipeline(dev, pipeline_kernels, absent=optin))
    phase_pipeline_vs_cpu(dev)
    train_counts, f32_default = phase_train(
        dev, train_kernels, smi, absent=optin,
        others=[cuda_mha.KERNEL_TILED, *cuda_pointconv.KERNELS[1:], cuda_gather.KERNEL_SCATTER,
                cuda_sa_train.KERNEL_E_FWD, cuda_sa_train.KERNEL_E_BWD])
    counts.append(train_counts)
    phase_train_vs_cpu(dev)
    counts.append(phase_dp(dev, smi))
    counts.append(phase_pipeline_optin(dev, pipeline_kernels + optin))
    counts.append(phase_serve(dev, serve_kernels + [cuda_ffn.KERNEL_TILED],
                              options=dict(fused_ffn="all"), phase="serve_optin"))
    phase_pipeline_vs_cpu(dev, PIPELINE_OPTIN, phase="pipeline_optin_vs_cpu")
    counts.append(phase_train_optin(dev, train_optin_kernels, f32_default))
    phase_train_vs_cpu(dev, fused_train=("e", "e", "e"), phase="train_optin_vs_cpu",
                       grad_cos=ECACHE_GRAD_COS, control=ECACHE_CONTROL)
    serve_paths_counts, scene = phase_serve_paths(dev, serve_kernels, smi, absent=optin)
    counts.append(serve_paths_counts)
    counts.append(phase_t5_text(dev, serve_kernels, smi, scene, absent=optin))
    counts.append(phase_readers_tables(dev, pipeline_kernels, smi, scene))
    counts.append(phase_prep_serve(dev, serve_kernels, smi, absent=optin))
    kernels = (serve_kernels + train_kernels[1:3] + list(cuda_pointconv.KERNELS[1:])
               + optin + [cuda_gather.KERNEL_SCATTER, cuda_sa_train.KERNEL_E_FWD,
                          cuda_sa_train.KERNEL_E_BWD, cuda_split.KERNEL])
    launches = {k.name: sum(c.get(k.name, 0) for c in counts) for k in kernels}
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": records[k.name].max_abs_err,
         "ms": records[k.name].ms, "plain_ms": records[k.name].plain_ms,
         "bound_ms": records[k.name].bound_ms, "bound_by": records[k.name].bound_by,
         "library_ms": records[k.name].library_ms,
         **({"max_ulps": records[k.name].max_ulps}
            if records[k.name].max_ulps is not None else {})}
        for k in kernels
    ]})
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
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
