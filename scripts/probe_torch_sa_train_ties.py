"""The training SA backward's check in chip_smoke.py at near-ties of the
neighbour max, on the card.

    python3 scripts/probe_torch_sa_train_ties.py [--draws 24]

chip_smoke.py's phase 3 holds sa_train_bwd against sa_train_backward_plain
at the kernel forward's BN statistics, by relative L2 error (1e-3 in f32,
floored at SA_TRAIN_GRAD_FLOOR x the largest gradient norm), both fed dout
with zeros at the pairs ops/sa_train.near_ties marks. Where two edges of a
center tie within rounding in a column, the kernel's z and the plain
version's (cuBLAS) z can pick different winners of the neighbour max,
which moves O(1) of gradient between the two edges. This script measures
that at the coarse step's three levels with chip_smoke.py's inputs, in
f32, and prints one JSON line per level:

- `fwd_err_kernel`, `fwd_err_plain`: max |out - out64| / max |out64| of the
  forward kernel's output and of the same function in f32 plain torch,
  both at the kernel forward's statistics; out64 is the function in f64;
- `rel_l2_kernel_stats`, `rel_l2_plain_stats`: the check's worst relative
  L2 error over the eight gradients, unmasked, the backward fed the kernel
  forward's statistics (as the smoke feeds it) and the plain forward's;
  `rel_l2_masked_kernel_stats`, `rel_l2_masked_plain_stats`: the same with
  dout zero at the near-ties (the smoke's form);
- `near_ties`, `near_tie_share`: the pairs near_ties marks at the kernel
  forward's statistics, and their share of the level's pairs (the smoke's
  limit: 1e-5); `tie_counts`: the count at limits 2^-17 .. 2^-21 of the
  scale (TIE_RTOL is one of them);
- `winners_differ`: every (center, column) where the plain f32 z and the
  f64 z put different edges first, with both edges' f64 and f32 values,
  the kernel forward's max there and the f64 gap over the pair's scale
  (`gap_over_scale`); `widest_flip`: the largest of those gaps;
- `fail_share`, `fail_share_masked`: the share of `--draws` draws of
  relative noise 1e-6 on the plain forward's statistics for which the
  check's worst error exceeds its limit, unmasked and masked (near-ties
  marked anew at each draw's statistics).

The first line is the card's nvidia-smi name and power limit. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(got, want, floor_frac):
    floor = floor_frac * max(w.norm().item() for w in want)
    return max(((g - w).norm() / max(w.norm().item(), floor)).item() for g, w in zip(got, want))


def forward64(u, sv, w2, idx, maskm, aux1, aux2):
    """The masked relu values of y2 [N, S, K, H2] in f64 and in f32, and
    the scale |a2| (sum_k |h1_k w2_kc| + |b2|) in f64, at the given
    statistics: h1 = relu(e * a1 + c1), z = h1 W2 + b2, y2 = z * a2 + c2."""
    n, p, h1w = u.shape
    s, k = idx.shape[1:]
    flat = idx.reshape(n, s * k, 1).long().expand(n, s * k, h1w)
    out = {}
    for dt in (torch.float64, torch.float32):
        e = (torch.gather(u.to(dt), 1, flat).reshape(n, s, k, h1w)
             - sv.to(dt)[:, :, None, :])
        h1 = torch.relu(e * aux1[0].to(dt) + aux1[1].to(dt))
        z = h1 @ w2.to(dt) + aux2[6].to(dt)
        y2 = z * aux2[0].to(dt) + aux2[1].to(dt)
        out[dt] = torch.where(maskm[..., None], torch.relu(y2),
                              torch.full((), -1e30, dtype=dt, device=u.device))
        if dt == torch.float64:
            scale = aux2[0].to(dt).abs() * (h1 @ w2.to(dt).abs() + aux2[6].to(dt).abs())
    return out[torch.float64], out[torch.float32], scale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_sa_train_ties: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from text2loc_tpu_torch.ops import cuda_fps, cuda_sa_train, sa_train
    from text2loc_tpu_torch.ops.ballquery import ball_query_knn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    limit = cs.REL_L2[torch.float32]
    # chip_smoke.phase_sa_train_kernels' inputs, drawn in its order.
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    noise = torch.Generator(device=dev).manual_seed(cs.SEED)
    n, k = 32 * 28, 32
    pts = cs._clouds(gen, n, 256, dev)
    _, xyz = cuda_fps.farthest_point_sampling_cuda(pts, 128)
    obj = (torch.arange(n, device=dev) % 28) < 21
    pos = pts
    for p, s, h1, h2, radius in [(256, 128, 32, 64, 0.2), (128, 64, 128, 128, 0.3),
                                 (64, 32, 256, 256, 0.4)]:
        ctr = xyz[:, :s].contiguous()
        idx, maskm = ball_query_knn(pos, ctr, radius, k)
        idx = idx.to(torch.int32).contiguous()
        maskf = maskm & obj[:, None, None]
        u = cs._rand(gen, (n, p, h1), 1.0, dev)
        sv = cs._rand(gen, (n, s, h1), 0.5, dev)
        w2 = cs._rand(gen, (h1, h2), h1 ** -0.5, dev)
        b2, be1, be2 = (cs._rand(gen, h, 0.1, dev) for h in (h2, h1, h2))
        g1, g2 = (cs._rand(gen, h, 0.1, dev, 1.0) for h in (h1, h2))
        dout = cs._rand(gen, (n, s, h2), 1.0, dev)
        pos = ctr
        f32 = torch.float32
        level = cuda_sa_train.Level(u, sv, w2, idx, maskm, maskf, f32)
        kout, kstats, kaux1, kaux2 = sa_train.forward_cuda(level, b2, g1, be1, g2, be2, maskf,
                                                           1e-5)
        _, pstats, paux1, paux2 = sa_train._forward_plain(u, sv, w2, b2, g1, be1, g2, be2, idx,
                                                          maskm, maskf, 1e-5, f32, None,
                                                          None)

        def check(a1, a2, n1, masked):
            d = dout
            if masked:
                d = dout.masked_fill(sa_train.near_ties(u, sv, w2, idx, maskm, a1, a2, f32),
                                     0.0)
            got = sa_train.backward_cuda(level, a1, a2, n1, d)
            want = sa_train.sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, a1, a2, n1,
                                                    d, f32)
            return rel_l2(got, want, cs.SA_TRAIN_GRAD_FLOOR)

        f64, f32v, scale = forward64(u, sv, w2, idx, maskm, kaux1, kaux2)
        out64 = f64.max(dim=2).values.clamp(min=0.0)
        peak = out64.abs().max().item()
        pout = f32v.max(dim=2).values.clamp(min=0.0)
        differ = (f32v.argmax(dim=2) != f64.argmax(dim=2)) & (out64 > 0)
        winners = []
        for nn, ss, cc in torch.nonzero(differ).tolist():
            vals, order = f64[nn, ss, :, cc].topk(2)
            a, b = order.tolist()
            winners.append({"cloud": nn, "center": ss, "column": cc, "edges": [a, b],
                             "f64": vals.tolist(),
                             "plain_f32": [f32v[nn, ss, a, cc].item(), f32v[nn, ss, b, cc].item()],
                             "kernel_max": kout[nn, ss, cc].item(),
                             "gap_over_scale": (vals[0] - vals[1]).item()
                             / scale[nn, ss, a, cc].item()})
        del f64, f32v, scale
        ties = sa_train.near_ties(u, sv, w2, idx, maskm, kaux1, kaux2, f32)
        counts = {f"2^-{e}": int(sa_train.near_ties(u, sv, w2, idx, maskm, kaux1, kaux2, f32,
                                                    rtol=2.0 ** -e).sum().item())
                  for e in range(17, 22)}
        fails = fails_masked = 0
        for _ in range(args.draws):
            a1, a2 = paux1.clone(), paux2.clone()
            for aux in (a1, a2):
                aux[:4] *= 1 + 1e-6 * torch.randn(aux[:4].shape, generator=noise, device=dev)
            fails += check(a1, a2, pstats[4], False) > limit
            fails_masked += check(a1, a2, pstats[4], True) > limit
        print(json.dumps({
            "level": f"P={p} S={s} H={h1}->{h2}", "pairs": n * s * h2,
            "fwd_err_kernel": (kout.double() - out64).abs().max().item() / peak,
            "fwd_err_plain": (pout.double() - out64).abs().max().item() / peak,
            "rel_l2_kernel_stats": check(kaux1, kaux2, kstats[4], False),
            "rel_l2_plain_stats": check(paux1, paux2, pstats[4], False),
            "rel_l2_masked_kernel_stats": check(kaux1, kaux2, kstats[4], True),
            "rel_l2_masked_plain_stats": check(paux1, paux2, pstats[4], True),
            "limit": limit, "near_ties": int(ties.sum().item()),
            "near_tie_share": ties.sum().item() / ties.numel(),
            "tie_rtol": sa_train.TIE_RTOL, "tie_counts": counts,
            "winners_differ": winners,
            "widest_flip": max((w["gap_over_scale"] for w in winners), default=None),
            "fail_share": fails / max(args.draws, 1),
            "fail_share_masked": fails_masked / max(args.draws, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
