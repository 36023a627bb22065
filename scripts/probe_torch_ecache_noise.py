"""How far one f32 ulp of noise in the hoisted first layer u moves a coarse
train step, with the bf16 edge cache ("e") and with the f32 level ("e32").

    python3 scripts/probe_torch_ecache_noise.py [--device cpu] [--tokens e,e,e e32,e32,e32]

Run from the root of a checkout. It builds chip_smoke.py's train_vs_cpu
step (the default Config at full width, f32 body, batch 8, dropout 0, no
augmentation, seeded weights) and takes it twice per token list: once as
is, once with u multiplied by (1 + 6e-8 * noise) at every SA level (noise
standard normal, seeded: about one f32 ulp, the size of the difference
between the card's and the CPU's matrix products). It prints, per token
list, the loss's relative change and chip_smoke's gradient report (worst
leaf rel-L2 and cosine, and the leaves outside rel 1e-3 / cos 0.9999).

The bf16 cache rounds e = u[idx] - sv to bf16, so a perturbation far below
the bf16 spacing still flips the rounding of some elements, and those
flips change neighbour-max winners at near-ties: the card and the CPU
compute this function apart by more than they compute the f32 one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tokens", nargs="*", default=["e,e,e", "e32,e32,e32"])
    args = ap.parse_args()

    import chip_smoke as cs
    import text2loc_tpu_torch.models.pointnet2 as pointnet2
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
    from text2loc_tpu_torch.training import steps as steps_lib

    sa_train = pointnet2.sa_train
    noisy = {"on": False}

    def sa_train_with_noise(u, *rest, **kw):
        if noisy["on"]:
            g = torch.Generator().manual_seed(1)
            u = u * (1 + 6e-8 * torch.randn(u.shape, generator=g).to(u.device))
        return sa_train(u, *rest, **kw)

    pointnet2.sa_train = sa_train_with_noise
    cfg = cs._train_cfg(batch_size=8, plain=True)
    data = cs._train_map(cfg, num_poses=16)
    emb = HintTextEmbedder.compositional(cfg.model.text_embed_dim,
                                         cfg.model.max_hint_tokens)
    batch = data.gather_coarse(np.arange(8), cfg.model.object_size)
    for tokens in args.tokens:
        runs = []
        for on in (False, True):
            noisy["on"] = on
            model = init_weights(build_model(cfg, "coarse", fused_train=tokens),
                                 torch.Generator().manual_seed(cs.SEED + 4)).to(args.device)
            opt = steps_lib.make_optimizer(model.parameters(), cfg, steps_per_epoch=1)
            step = steps_lib.make_coarse_train_step(
                model, emb, cfg, opt, torch.Generator(device=args.device).manual_seed(cs.SEED))
            loss = float(step(batch)["loss"])
            runs.append((loss, {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                                if p.grad is not None}))
        (l0, g0), (l1, g1) = runs
        rel, cos, floor, bad = cs._grad_report(g1, g0)
        print(json.dumps({"tokens": tokens, "device": args.device,
                          "loss_rel_change": abs(l1 - l0) / abs(l0), "worst_grad_rel_l2": rel,
                          "worst_grad_cos": cos, "grad_floor": floor,
                          "leaves_outside_rel_1e-3_cos_0.9999": len(bad),
                          "grad_leaves": len(g0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
