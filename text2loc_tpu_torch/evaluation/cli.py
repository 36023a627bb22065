"""Evaluation CLIs of the port (port of text2loc_tpu/evaluation/cli.py:
main_pipeline, main_coarse) with the JAX package's flags and --device.

    python -m text2loc_tpu_torch.evaluation.pipeline --synthetic --device cpu \
        --fused_sa full,full,all
    python -m text2loc_tpu_torch.evaluation.pipeline --base_path DATA \
        --array_cache DATA/arrays [--use_test_set]

Data: --synthetic builds an 8-cell scene at the small test config; else
--base_path is a KITTI360Pose pickle root, converted once by data/ingest.py
into --array_cache, and the val split (--use_test_set: test) is served at
the default Config.

Weights: a reference-layout .pth per tower (--coarse_torch_ckpt,
--fine_torch_ckpt), loaded with strict=False semantics; what a checkpoint
lacks keeps the port's seeded random initialization (convert.init_weights,
seed 0). --coarse_ckpt / --fine_ckpt load the best checkpoint of the port's
trainers (utils/checkpoint.py; not the JAX package's Orbax files).

Styled hints: --styled_hints re-renders every pose's description through
the paraphrase banks and serves it through Localizer.localize_text, with the
frozen T5 encoder of --t5_snapshot (a local HF snapshot, read without
transformers) or the compositional stand-in. The flags of paths the port
does not have yet raise an error that names the ROADMAP item they wait for;
none is ignored.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from text2loc_tpu_torch.config import Config

# Flag -> the ROADMAP item the port's support of it waits for.
_NOT_PORTED = {
    "plot_retrievals": "a port copy of evaluation/visualize.py (ROADMAP Queue 1 item 8)",
}


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--base_path", default=None,
                    help="KITTI360Pose pickle root (data/ingest.py converts it)")
    ap.add_argument("--array_cache", default=None,
                    help="npz cache directory of the converted scenes")
    ap.add_argument("--coarse_ckpt", default=None,
                    help="the port's coarse checkpoint directory "
                         "(<workdir>/coarse_ckpt of the coarse trainer)")
    ap.add_argument("--fine_ckpt", default=None,
                    help="the port's fine checkpoint directory (<workdir>/fine_ckpt)")
    ap.add_argument("--coarse_torch_ckpt", default=None,
                    help="reference-layout coarse .pth")
    ap.add_argument("--fine_torch_ckpt", default=None,
                    help="reference-layout fine .pth")
    ap.add_argument("--use_test_set", action="store_true",
                    help="evaluate the test split of --base_path instead of val")
    ap.add_argument("--synthetic", action="store_true",
                    help="an 8-cell synthetic scene at the small test config")
    ap.add_argument("--plot_retrievals", default=None)
    ap.add_argument("--text_table", default=None,
                    help="frozen T5 table .npz; default: the compositional stand-in")
    ap.add_argument("--reference_attention", action="store_true",
                    help="attend/pool over padded slots like the reference")
    ap.add_argument("--fused_sa", default=None,
                    help="SA mode (off|first|full|gather|exact|all|1, or a "
                         "per-level comma list); default 'first' on the card "
                         "and 'off' on the CPU, as the JAX package picks per "
                         "backend")
    ap.add_argument("--top_k", type=int, nargs="*", default=None,
                    help="retrieval depths (default 1 3 5 10)")
    ap.add_argument("--threshs", type=float, nargs="*", default=None,
                    help="localization error thresholds in meters (default 5 10 15)")
    ap.add_argument("--styled_hints", action="store_true",
                    help="paraphrase-robustness eval: re-render every query through "
                         "the sentence_style_* banks (text_styles.py) and serve the "
                         "styled (out-of-vocabulary) strings through localize_text's "
                         "online encoder; prints styled vs canonical recall")
    ap.add_argument("--styled_seed", type=int, default=0,
                    help="paraphrase sampling seed for --styled_hints")
    ap.add_argument("--t5_snapshot", default=None,
                    help="local HF T5 snapshot directory (config.json, "
                         "model.safetensors or pytorch_model.bin, tokenizer.json) for "
                         "the online encoder; default: the compositional stand-in "
                         "matched to the table embedder")
    ap.add_argument("--sentence_table", action="store_true",
                    help="encode eval queries via the [V, D] sentence table")
    return ap


def _check_flags(args):
    """Raise on a flag of a path the port does not have yet."""
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: the port does not have it yet; it "
                                      f"waits for {item}")
    return args


def _parse(argv):
    return _check_flags(build_argparser().parse_args(argv))


def _apply_model_flags(cfg, args):
    if args.reference_attention:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, mask_padded=False))
    ev = {}
    if args.top_k:
        ev["top_k"] = tuple(args.top_k)
    if args.threshs:
        ev["threshs"] = tuple(args.threshs)
    if args.sentence_table:
        ev["sentence_table"] = True
    if ev:
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, **ev))
    return cfg


def _load(args):
    """(cfg, data): with --synthetic, an 8-cell scene at the small test
    config; else the val (--use_test_set: test) split of --base_path at the
    default Config, converted once into --array_cache."""
    if args.synthetic:
        from text2loc_tpu_torch.config import small_test_config
        from text2loc_tpu_torch.data.arrays import MultiSceneArrays
        from text2loc_tpu_torch.data.synthetic import make_scene

        cfg = small_test_config()
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, top_k=(1, 2, 3)))
        data = MultiSceneArrays([
            make_scene("0009", num_cells=8, num_poses=24,
                       object_slots=cfg.model.object_size,
                       num_points=cfg.model.pointnet.num_points,
                       num_mentioned=cfg.model.num_mentioned, seed=9)])
        return cfg, data
    if not args.base_path:
        raise ValueError("--base_path or --synthetic required")
    from text2loc_tpu_torch.data.ingest import load_dataset

    split = "test" if args.use_test_set else "val"
    return Config().validate(), load_dataset(args.base_path, split,
                                             out_dir=args.array_cache)


def _sa_mode(args, device) -> str:
    if args.fused_sa:
        return args.fused_sa
    return "first" if torch.device(device).type == "cuda" else "off"


def _model(cfg, kind, args, path, gen):
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.torch_checkpoint import load_reference_checkpoint
    from text2loc_tpu_torch.utils.checkpoint import load_model_state

    model = init_weights(build_model(cfg, kind, sa_mode=_sa_mode(args, args.device)), gen)
    if path:
        load_reference_checkpoint(model, path, cfg.model, kind)
    ckpt = args.coarse_ckpt if kind == "coarse" else args.fine_ckpt
    if ckpt:
        load_model_state(model, ckpt)
    return model


def _setup(argv):
    from text2loc_tpu_torch.models.text_embedding import make_embedder

    args = _parse(argv)
    cfg, data = _load(args)
    cfg = _apply_model_flags(cfg, args)
    cfg, embedder = make_embedder(cfg, args.text_table)
    return args, cfg, data, embedder


def main_pipeline(argv=None) -> dict:
    """Coarse retrieval -> fine refinement -> both tables, printed and
    returned (run_pipeline's dict)."""
    from text2loc_tpu_torch.evaluation.pipeline import run_pipeline

    args, cfg, data, embedder = _setup(argv)
    gen = torch.Generator().manual_seed(0)
    coarse = _model(cfg, "coarse", args, args.coarse_torch_ckpt, gen)
    fine = _model(cfg, "fine", args, args.fine_torch_ckpt, gen)
    result = run_pipeline(data, coarse, fine, embedder, cfg, device=args.device)
    if args.styled_hints:
        result["styled"] = run_styled(args, cfg, data, coarse, fine, embedder)
    return result


def online_encoder(args, cfg):
    """The online encoder of --t5_snapshot (on --device), or None."""
    if not args.t5_snapshot:
        return None
    from text2loc_tpu_torch.models.t5_encoder import T5OnlineEncoder

    return T5OnlineEncoder.from_snapshot(args.t5_snapshot,
                                         max_tokens=cfg.model.max_hint_tokens,
                                         device=args.device)


def run_styled(args, cfg, data, coarse, fine, embedder) -> dict:
    """--styled_hints: paraphrased queries through the serving front door,
    with the --t5_snapshot encoder or the compositional stand-in."""
    from text2loc_tpu_torch.evaluation.styled import eval_styled_retrieval
    from text2loc_tpu_torch.models.t5_encoder import CompositionalOnlineEncoder
    from text2loc_tpu_torch.serving import Localizer

    online = online_encoder(args, cfg) or CompositionalOnlineEncoder(
        embed_dim=cfg.model.text_embed_dim, max_tokens=cfg.model.max_hint_tokens)
    localizer = Localizer(data, coarse, fine, embedder, cfg, top_k=max(cfg.eval.top_k),
                          online_encoder=online, device=args.device)
    out = eval_styled_retrieval(localizer, data, seed=args.styled_seed,
                                top_k=cfg.eval.top_k)
    for name in ("canonical", "styled"):
        r = out[name]
        ks = " ".join(f"R@{k}={v:.3f}" for k, v in r["recall"].items())
        print(f"[styled_hints] {name:9s} {ks} mean_err={r['mean_error_m']:.2f}m")
    gaps = " ".join(f"@{k}={v:+.3f}" for k, v in out["recall_gap"].items())
    print(f"[styled_hints] canonical-minus-styled recall gap: {gaps}")
    return out


def main_coarse(argv=None):
    """Coarse retrieval only: (table, retrievals)."""
    from text2loc_tpu_torch.evaluation.metrics import print_accuracies
    from text2loc_tpu_torch.evaluation.pipeline import run_coarse

    args, cfg, data, embedder = _setup(argv)
    model = _model(cfg, "coarse", args, args.coarse_torch_ckpt,
                   torch.Generator().manual_seed(0)).to(args.device).eval()
    accs, retrievals = run_coarse(data, model, embedder.to(args.device), cfg,
                                  device=args.device)
    print_accuracies(accs, "Coarse")
    return accs, retrievals
