"""The neighbour gather at training shapes, forward and backward, on one
CUDA card: the port's twin of scripts/probe_gather_train.py.

    python3 scripts/probe_torch_gather_train.py [--n 896] [--iters 20]

Run from the root of a checkout. At the three training SA levels (P, Q =
S x K, C = H1: (256, 4096, 32), (128, 2048, 128), (64, 1024, 256), N
clouds, random indices) it times the value and gradient of
sum(gather(u, idx) ** 2) for three formulations:

* torch_gather: torch.gather over an expanded view of the int64 index
  [N, Q, 1] -> [N, Q, C], autograd (its backward is ATen's scatter_add_);
* index_select: the clouds' rows flattened to [N * P, C] and one
  index_select over the flattened indices (backward: index_add_);
* gather_rows_grad: the port's kernels (csrc/gather_rows.cu: the row
  gather, and the scatter-add without float atomics in the backward).

Times are medians of `iters` calls by CUDA events, after a warm-up call.
It checks that the three agree (forward bit-equal, gradient within 1e-6 x
max|grad|) and prints one JSON line per level and the card's nvidia-smi
name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LEVELS = [("sa1", 256, 128, 32, 32), ("sa2", 128, 64, 32, 128), ("sa3", 64, 32, 32, 256)]


def median_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=896)   # 32 poses x 28 objects
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_gather_train: no CUDA device", file=sys.stderr)
        return 2
    from text2loc_tpu_torch.ops.gather import gather_rows_grad

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    n = args.n

    for name, p, s, k, c in LEVELS:
        q = s * k
        u = torch.randn(n, p, c, generator=gen).to(dev)
        idx = torch.randint(0, p, (n, q), generator=gen).to(torch.int32).to(dev)
        full = idx.long()[..., None].expand(n, q, c)
        flat = (idx.long() + torch.arange(n, device=dev)[:, None] * p).reshape(-1)

        forms = {
            "torch_gather": lambda v: torch.gather(v, 1, full),
            "index_select": lambda v: v.reshape(n * p, c).index_select(0, flat).reshape(n, q, c),
            "gather_rows_grad": lambda v: gather_rows_grad(v, idx),
        }

        def value_and_grad(form):
            v = u.detach().requires_grad_()
            loss = form(v).square().sum()
            loss.backward()
            return loss.detach(), v.grad

        results = {key: value_and_grad(f) for key, f in forms.items()}
        want_loss, want_grad = results["torch_gather"]
        tol = 1e-6 * want_grad.abs().max().item()
        for key, (loss, grad) in results.items():
            ok = (torch.equal(forms[key](u), forms["torch_gather"](u))
                  and (grad - want_grad).abs().max().item() <= tol)
            if not ok:
                raise AssertionError(f"{name}: {key} disagrees with torch.gather")
        row = {key: median_ms(lambda f=f: value_and_grad(f), args.iters)
               for key, f in forms.items()}
        print(json.dumps({"level": name, "n": n, "p": p, "q": q, "c": c,
                          "value_and_grad_ms": row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
