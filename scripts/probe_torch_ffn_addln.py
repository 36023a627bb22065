"""Split the feed-forward block's time on the card into the kernels, the
wrapper's host dispatch and its extra device ops: the fused block
(`ffn_addln`, d <= 256), the tiled chain (`ffn_addln_tiled`) and its
stages, and the add+LayerNorm block (`add_ln`) that shares the chain's row
LayerNorm.

    python3 scripts/probe_torch_ffn_addln.py [--root DIR] [--reps 10] [--cases all|fused|tiled|ln]

`--root` names the checkout whose text2loc_tpu_torch is timed (default:
the one holding this script), e.g. a parent commit unpacked with `git
archive` beside the working tree; run parent, change, change, parent in
one call to compare two trees on one card.

`--cases fused`: chip_smoke.py's three fused cases (the CCT over 640 x 16
rows at D=128, F=512; obj_inter at D=256, F=512; the coarse inter head at
D=256, F=1024), a batch-1 serve request's three (the inter head over 6
rows, the CCT's hint and object layers over the top-10 cells, 60 and 160
rows) and the batch-64 request's CCT hint layer (3840 rows).
`--cases tiled`: the E=1024 trunk's block (D=1024, F=4096) at the intra
stack's 25,344 rows (chip_smoke.py's case) and at 39 and 592 rows, and
chip_smoke.py's wide f32 shape (384 rows, D=2048, F=8192: 48 output tiles
of the residual product for 132 SMs).
`--cases ln`: chip_smoke.py's six add_ln cases (the E=1024 trunk's 25,344
rows at D=1024, the CCT's 10,240 at D=128, obj_inter's 1792 at D=256).
Inputs as the smoke makes them: bf16 or f32 activations, f32 weights and
vectors (as the model passes its parameters). For each shape and dtype it
prints one JSON line:

- `ms`: one wrapper call (ops/cuda_ffn.ffn_addln_cuda,
  ops/cuda_ln.add_layernorm_cuda) per CUDA event pair, median of `--reps`,
  as chip_smoke.py times it: the host dispatch is inside it;
- `kernel_ms`: the kernel alone on inputs prepared as the kernel takes them
  (weights pre-cast where the kernel needs that, scratch allocated
  beforehand), chip_smoke.py's kernel_ms: 50 back-to-back launches between
  two events, divided by 50, queued behind a device sleep so that the
  host's dispatch is outside; for the tiled chain its C entry
  t2l_ffn_addln_tiled, for add_ln the wrapper call;
- tiled lines: `hidden_ms` and `out_addln_ms`, each stage's C entry timed
  as `kernel_ms` on the plain stages' inputs (t2l_ffn_tiled_gemm_relu;
  t2l_ffn_tiled_out_addln, or, in a checkout without that entry,
  `kernel_ms` less `hidden_ms`, marked by `"out_addln_by": "difference"`);
  in f32, where the products read the weights' TF32 split, `split_ms`, the
  split of W1 and W2 alone (ops/cuda_split.split_t_cuda), which the
  block's `kernel_ms` includes and the stages' exclude; and `stock_ms`: the
  port's fused_ffn="0" block (chip_smoke.py's _stock_ffn_fn), timed as
  `ms`;
- ln lines: `library_ms`, F.layer_norm(x + res), timed as `ms`;
- `device_ops`: device ops (kernels and copies) per wrapper call, from
  torch.profiler over `--reps` calls (a window with none taken again);
- `plain_ms`: the plain version (ops/ffn.ffn_addln_plain,
  ops/ln.add_layernorm_plain), timed as `ms`;
- fused lines: `plan`, the fused plan's tile rows, cluster and blocks,
  where the checkout plans one.

The inputs and timers are this checkout's chip_smoke.py's, so two
checkouts are timed alike. A checkout whose cuda_ffn has no fused_plan
(the fused kernel before its redesign) is timed through its own C entry,
on weights cast beforehand.

The first line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
# (name, rows, D, F)
SMOKE = [("cct", 640 * 16, 128, 512), ("obj_inter", 64 * 28, 256, 512),
         ("inter head", 64 * 6, 256, 1024)]
REQUEST = [("req inter head", 6, 256, 1024), ("req cct hint", 60, 128, 512),
           ("req cct obj", 160, 128, 512), ("req64 cct hint", 3840, 128, 512)]
TILED = [("intra E=1024", 1584 * 16, 1024, 4096), ("ragged 39", 39, 1024, 4096),
         ("ragged 592", 592, 1024, 4096), ("wide", 384, 2048, 8192)]
# (name, rows, D): chip_smoke.py's add_ln cases.
LN = [("intra E=1024", 1584 * 16, 1024), ("cct", 640 * 16, 128), ("obj_inter", 64 * 28, 256)]


def device_ops(fn, reps: int) -> float:
    """Device ops per fn() under torch.profiler over `reps` calls; a window
    in which the profiler recorded no device op at all (it happens on the
    card) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if ops:
            break
    return ops / reps


def bare_kernel(smoke, cuda_ffn, args):
    """fn() launching the kernel alone, with no count and no host-side
    preparation: the redesigned entry (chip_smoke._fused_ffn_fn, which takes
    the weights as the model gives them), or the earlier C entry
    t2l_ffn_addln on pre-cast weights."""
    if hasattr(cuda_ffn, "fused_plan"):
        return smoke._fused_ffn_fn(args)
    from text2loc_tpu_torch.ops import _cuda

    x, w1, b1, w2, b2, g, be = args
    dt = x.dtype
    d, f = w1.shape
    w1c, w2c, out = w1.to(dt).contiguous(), w2.to(dt).contiguous(), torch.empty_like(x)
    fn = _cuda.library().t2l_ffn_addln
    rest = (x.numel() // d, d, f, ctypes.c_float(1e-5), _cuda.DTYPE_CODE[dt])

    def run():
        fn(*(_cuda.ptr(t) for t in (x, w1c, b1, w2c, b2, g, be, out)), *rest,
           torch.cuda.current_stream().cuda_stream)
    return run


def tiled_stages(args, reps: int, kernel_ms) -> dict:
    """kernel_ms of the chain's C entry and of each stage's, on weights cast
    and scratch allocated beforehand; the stages on the plain stages'
    inputs. In f32, in a checkout whose products read the weights' TF32
    split (t2l_tf32_split_t): the split alone as `split_ms`, the block's
    `kernel_ms` with its split launched first, the stages on a split made
    beforehand."""
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.ops.ffn import ffn_hidden_plain

    lib = _cuda.library()
    x, w1, b1, w2, b2, g, be = args
    dt, dev = x.dtype, x.device
    rows, (d, f) = x.shape[0], w1.shape
    code = _cuda.DTYPE_CODE[dt]
    w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    h = torch.empty((rows, f), dtype=dt, device=dev)
    s2 = torch.empty((rows, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    hp = ffn_hidden_plain(x, w1, b1)
    eps = ctypes.c_float(1e-5)
    p = _cuda.ptr
    found = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ok(err):
        if err:
            raise RuntimeError(lib.t2l_error_string(err).decode())

    if hasattr(lib, "t2l_tf32_split_t"):
        from text2loc_tpu_torch.ops import cuda_split

        f32 = dt == torch.float32
        null = (None, None)
        split = cuda_split.split_t_cuda([w1c, w2c]) if f32 else None
        wt1 = (p(split[0]), p(split[1])) if f32 else null
        wt2 = (p(split[0][f * d:]), p(split[1][f * d:])) if f32 else null
        scratch = torch.empty((2, 2 * d * f), dtype=dt, device=dev) if f32 else None

        def block():
            # In f32 the entry writes the split into the scratch first.
            ok(lib.t2l_ffn_addln_tiled(
                *(p(t) for t in (x, w1c, b1, w2c, b2)),
                *(cuda_split.halves(scratch) if f32 else null),
                *(p(t) for t in (g, be, out, h, s2)), rows, d, f, eps, code, stream()))

        def hidden():
            ok(lib.t2l_ffn_tiled_gemm_relu(p(x), p(w1c), *wt1, p(b1), p(h), rows, d, f, code,
                                           stream()))

        def out_addln():
            ok(lib.t2l_ffn_tiled_out_addln(p(x), p(hp), p(w2c), *wt2,
                                           *(p(t) for t in (b2, g, be, out, s2)), rows, d, f,
                                           eps, code, stream()))

        if f32:
            found["split_ms"] = kernel_ms(lambda: cuda_split.split_t_cuda([w1c, w2c]), reps)
        found.update(kernel_ms=kernel_ms(block, reps), hidden_ms=kernel_ms(hidden, reps),
                     out_addln_ms=kernel_ms(out_addln, reps))
        return found

    def block():
        ok(lib.t2l_ffn_addln_tiled(*(p(t) for t in (x, w1c, b1, w2c, b2, g, be, out, h, s2)),
                                   rows, d, f, eps, code, stream()))

    def hidden():
        ok(lib.t2l_ffn_tiled_gemm_relu(p(x), p(w1c), p(b1), p(h), rows, d, f, code, stream()))

    found = {"kernel_ms": kernel_ms(block, reps), "hidden_ms": kernel_ms(hidden, reps)}
    if hasattr(lib, "t2l_ffn_tiled_out_addln"):
        found["out_addln_ms"] = kernel_ms(
            lambda: ok(lib.t2l_ffn_tiled_out_addln(
                *(p(t) for t in (x, hp, w2c, b2, g, be, out, s2)), rows, d, f, eps, code,
                stream())), reps)
    else:
        found["out_addln_ms"] = found["kernel_ms"] - found["hidden_ms"]
        found["out_addln_by"] = "difference"
    return found


def ln_args(smoke, gen, dev, dt, rows, d):
    """One add_ln case's inputs, as chip_smoke.py's phase_optin_kernels
    makes them."""
    x = smoke._rand(gen, (rows, d), 2.0, dev, 0.3).to(dt)
    res = smoke._rand(gen, (rows, d), 1.0, dev).to(dt)
    return x, res, smoke._rand(gen, d, 0.1, dev, 1.0), smoke._rand(gen, d, 0.1, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", choices=("all", "fused", "tiled", "ln"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_ffn_addln: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # This checkout's chip_smoke.py (its timers and inputs), whatever --root is.
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from text2loc_tpu_torch.ops import _cuda, cuda_ffn, cuda_ln
    from text2loc_tpu_torch.ops.ffn import ffn_addln_plain
    from text2loc_tpu_torch.ops.ln import add_layernorm_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED)
    ffn_cases = ((SMOKE + REQUEST if args.cases in ("all", "fused") else [])
                 + (TILED if args.cases in ("all", "tiled") else []))
    for dt in (torch.bfloat16, torch.float32):
        for name, rows, d, f in ffn_cases:
            a = smoke._ffn_args(gen, dev, dt, rows, d, f)

            def call(a=a):
                return cuda_ffn.ffn_addln_cuda(*a)

            route = cuda_ffn.route(d, f, dt)
            line = {"root": root, "case": f"{name} R={rows} D={d} F={f}",
                    "dtype": str(dt).split(".")[-1], "route": route,
                    "ms": smoke.cuda_ms(call, args.reps)}
            if route == "fused":
                plan = (cuda_ffn.fused_plan(rows, d, f, dt, sms=sms)
                        if hasattr(cuda_ffn, "fused_plan") else None)
                line["plan"] = None if plan is None else [plan.rows, plan.cluster, plan.blocks]
                line["kernel_ms"] = smoke.kernel_ms(bare_kernel(smoke, cuda_ffn, a), args.reps)
            else:
                line.update(tiled_stages(a, args.reps, smoke.kernel_ms))
                line["stock_ms"] = smoke.cuda_ms(smoke._stock_ffn_fn(a, dt), args.reps)
            line["device_ops"] = device_ops(call, args.reps)
            line["plain_ms"] = smoke.cuda_ms(lambda a=a: ffn_addln_plain(*a), args.reps)
            print(json.dumps(line), flush=True)
    if args.cases in ("all", "ln"):
        for name, rows, d in LN:
            for dt in (torch.bfloat16, torch.float32):
                a = ln_args(smoke, gen, dev, dt, rows, d)

                def call(a=a):
                    return cuda_ln.add_layernorm_cuda(*a)

                print(json.dumps({
                    "root": root, "case": f"add_ln {name} R={rows} D={d}",
                    "dtype": str(dt).split(".")[-1], "ms": smoke.cuda_ms(call, args.reps),
                    "kernel_ms": smoke.kernel_ms(call, args.reps),
                    "library_ms": smoke.cuda_ms(
                        lambda a=a, d=d: torch.nn.functional.layer_norm(
                            a[0] + a[1], (d,), a[2].to(a[0].dtype), a[3].to(a[0].dtype), 1e-5),
                        args.reps),
                    "device_ops": device_ops(call, args.reps),
                    "plain_ms": smoke.cuda_ms(lambda a=a: add_layernorm_plain(*a), args.reps)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
