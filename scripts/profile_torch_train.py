"""Where the time of the port's train steps goes on one CUDA card.

    python3 scripts/profile_torch_train.py [--reps 5] [--dp] [--out FILE]

Run from the root of a checkout. It builds the training that chip_smoke.py
drives (the default Config with its f32 body, batch 32, a synthetic map of
32 cells and 96 poses, seeded random weights) and profiles two phases with
torch.profiler, each after one warm-up step:

* coarse: `reps` coarse train steps (make_coarse_train_step);
* fine: `reps` fine train steps (make_fine_train_step, pad_size 16).

For each phase it prints one JSON line, per step, with the fields of
scripts/profile_torch_serve.py (wall_ms, wall_ms_profiled, device_ms,
busy_ms, idle_share, device_ops, top) and sa_train_ms / sa_train_share: the
device time of the training SA kernels (csrc/sa_train_fwd.cu,
csrc/sa_train_bwd.cu) and its share of device_ms, sa_train_fwd_ms and
sa_train_bwd_ms: that of the forward and the backward passes alone (their
reduce launches not counted), and
sa_levels: per training SA level of one more step, its shape and its valid
edges (maskm) and statistics edges (maskf), the work the sa_train kernels
scale with. Batches are gathered on
the host before the timing, as train_coarse times its steps. Each line
also holds host_ops, the host's aten ops a step. With --dp, each phase
runs again from the same weights as the data-parallel step over a mesh of
one rank (NCCL, parallel/mesh.py; phases coarse_dp1 and fine_dp1, with
the collectives a step). The profiler's full tables go to --out. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.autograd import DeviceType

import profile_torch_serve as prof_lib

REPO = prof_lib.REPO
SEED = 0
# The kernels of csrc/sa_train_fwd.cu and csrc/sa_train_bwd.cu ("sa_bwd"
# names every backward pass's kernel, of this design and the one before;
# "sa_stats1_kernel" and "sa_fwd" the forward's, "sa_stats_kernel" and
# "sa_out_kernel" the forward's of the design before).
SA_TRAIN_FWD_KERNELS = ("sa_stats_kernel", "sa_out_kernel", "sa_stats1_kernel", "sa_fwd")
SA_TRAIN_KERNELS = SA_TRAIN_FWD_KERNELS + ("sa_reduce_kernel", "sa_bwd")


def sa_train_ms(prof, per: int, names=SA_TRAIN_KERNELS) -> float:
    """Device milliseconds of the kernels whose names hold one of `names`,
    divided by `per`."""
    total_us = 0.0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and any(k in evt.name for k in names):
            total_us += evt.time_range.end - evt.time_range.start
    return total_us / 1e3 / per


def level_edges(train_step) -> list:
    """Shape and edge counts of every training SA level that one step of
    `train_step` builds on the card (ops/cuda_sa_train.Level)."""
    from text2loc_tpu_torch.ops import cuda_sa_train

    seen, init = [], cuda_sa_train.Level.__init__

    def record(self, u, sv, w2, idx, maskm, maskf, *rest, **kw):
        init(self, u, sv, w2, idx, maskm, maskf, *rest, **kw)
        seen.append({"clouds": self.n, "P": self.p, "S": self.s, "K": self.k,
                     "H1": self.h1, "H2": self.h2, "edges": int(maskm.sum()),
                     "edges_f": int(maskf.sum())})

    cuda_sa_train.Level.__init__ = record
    try:
        train_step()
    finally:
        cuda_sa_train.Level.__init__ = init
    return seen


def host_ops(prof, per: int) -> float:
    """The host's aten ops of one profile, divided by `per`."""
    return sum(1 for evt in prof.events()
               if evt.device_type == DeviceType.CPU and evt.name.startswith("aten::")) / per


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--dp", action="store_true",
                        help="also each phase as the DP step over a mesh of one rank (NCCL)")
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                      "profile_torch_train.txt"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.ops import _cuda
    from text2loc_tpu_torch.training import steps as steps_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _cuda.library()
    cfg = chip_smoke._train_cfg(batch_size=32)
    data = chip_smoke._train_map(cfg, num_poses=96)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    gen = torch.Generator().manual_seed(SEED)
    b = cfg.train.batch_size
    rows = [np.arange(b * i, b * (i + 1)) % data.num_poses for i in range(3)]
    mesh = None
    if args.dp:
        from text2loc_tpu_torch.parallel.mesh import make_mesh

        store = os.path.join(tempfile.mkdtemp(prefix="t2l_profile_dp_"), "store")
        mesh = make_mesh(1, device=dev, backend="nccl", init_method=f"file://{store}",
                         rank=0, world_size=1)
    phases = []
    for kind in ("coarse", "fine"):
        weights = init_weights(build_model(cfg, kind), gen).state_dict()
        if kind == "coarse":
            batches = [data.gather_coarse(r, cfg.model.object_size) for r in rows]
        else:
            batches = [data.gather_fine(r, cfg.model.pad_size) for r in rows]
        for name, on in ((kind, None), (kind + "_dp1", mesh)):
            if name != kind and mesh is None:
                continue
            model = build_model(cfg, kind).to(dev)
            model.load_state_dict(weights)
            opt = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch=3)
            make = (steps_lib.make_coarse_train_step if kind == "coarse"
                    else steps_lib.make_fine_train_step)
            step = make(model, emb, cfg, opt, torch.Generator(device=dev).manual_seed(SEED),
                        mesh=on)
            calls = iter(range(1 << 30))

            def train_step(step=step, batches=batches, calls=calls):
                return step(batches[next(calls) % len(batches)])

            train_step()                          # warm-up: allocator, cuBLAS handles
            wall = prof_lib.timed(train_step, args.reps)
            before = dict(on.calls) if on is not None else {}
            prof, wall_prof = prof_lib.profiled(train_step, args.reps)
            coll = ({k: (v - before.get(k, 0)) / args.reps for k, v in on.calls.items()}
                    if on is not None else {})
            phases.append((name, wall, wall_prof, prof, level_edges(train_step), coll))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for name, wall, wall_prof, prof, levels, coll in phases:
            s = prof_lib.device_summary(prof, args.reps)
            sa = sa_train_ms(prof, args.reps)
            print(json.dumps({"phase": name, "per": "step", "wall_ms": wall,
                              "wall_ms_profiled": wall_prof,
                              "idle_share": 1.0 - s["busy_ms"] / wall,
                              "sa_train_ms": sa, "sa_train_share": sa / s["device_ms"],
                              "sa_train_fwd_ms": sa_train_ms(prof, args.reps,
                                                             SA_TRAIN_FWD_KERNELS),
                              "sa_train_bwd_ms": sa_train_ms(prof, args.reps, ("sa_bwd",)),
                              "host_ops": host_ops(prof, args.reps), "collectives": coll,
                              "sa_levels": levels, **s}),
                  flush=True)
            f.write(f"== {name} ({args.reps} steps)\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=40))
            f.write("\n")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "out": os.path.relpath(args.out, REPO)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
