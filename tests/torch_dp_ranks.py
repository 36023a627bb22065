"""What the ranks of tests/test_torch_port_dp.py run: each function below
runs in a spawned process as one rank of a gloo group on the CPU
(text2loc_tpu_torch.dryrun.run_ranks), and the test process calls the same
functions without a mesh for the single-device side. This module imports
torch and the port only, so that no rank imports JAX or runs a JAX
collective."""

import dataclasses

import numpy as np
import torch

from text2loc_tpu_torch.config import small_test_config
from text2loc_tpu_torch.convert import build_model, init_weights
from text2loc_tpu_torch.data.arrays import MultiSceneArrays
from text2loc_tpu_torch.data.synthetic import make_scene
from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder
from text2loc_tpu_torch.parallel.mesh import all_reduce_, global_sums, shard_batch
from text2loc_tpu_torch.training import steps

LR = 1e-3


def cfg_of(ranking_loss="pairwise", batch=8, **train):
    """The small test config (dropout and augmentation on) with `batch`."""
    cfg = small_test_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=batch, **train,
        loss=dataclasses.replace(cfg.train.loss, ranking_loss=ranking_loss)))


def scene(cfg, num_cells=6, num_poses=16, seed=0, pose_seed=None):
    m = cfg.model
    return MultiSceneArrays([make_scene(f"{seed:04d}", num_cells=num_cells,
                                        num_poses=num_poses, object_slots=m.object_size,
                                        num_points=m.pointnet.num_points,
                                        num_mentioned=m.num_mentioned, seed=seed,
                                        pose_seed=pose_seed)])


def embedder(cfg):
    return HintTextEmbedder.compositional(cfg.model.text_embed_dim, cfg.model.max_hint_tokens)


def model_of(cfg, kind, fused_train=None, state=None):
    """A model of `kind` with seeded weights, or the weights of `state`."""
    model = build_model(cfg, kind, sa_mode="off", fused_train=fused_train)
    if state is None:
        return init_weights(model, torch.Generator().manual_seed(3))
    model.load_state_dict(state)
    return model


def train_step(cfg, kind, batch, fused_train=None, state=None, mesh=None) -> dict:
    """One train step of `kind` from model_of's weights with the generator
    seeded alike: {"loss", "grads": {name: grad}, "stats": {BN running
    statistics}}; under `mesh`, on this rank's rows of `batch`."""
    model = model_of(cfg, kind, fused_train, state)
    opt = steps.make_optimizer(model.parameters(), cfg, steps_per_epoch=1, lr=LR)
    make = steps.make_coarse_train_step if kind == "coarse" else steps.make_fine_train_step
    step = make(model, embedder(cfg), cfg, opt, torch.Generator().manual_seed(5), mesh=mesh)
    out = step(batch if mesh is None else shard_batch(batch, mesh))
    return {"loss": float(out["loss"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}}


def step_rank(mesh, cases) -> list:
    """train_step of each (cfg, kind, batch, fused_train, state) case."""
    return [train_step(*case, mesh=mesh) for case in cases]


def bn_rank(mesh, x, mask, w) -> dict:
    """MaskedBatchNorm in training over this rank's rows of x [B, F] (mask
    [B] or None): the output rows, the input's gradient of sum(out * w),
    the parameters' gradients summed over the ranks, the running
    statistics."""
    from text2loc_tpu_torch.models.mlp import MaskedBatchNorm

    bn = MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[-1]))
    bn.mesh = mesh
    if mesh is not None:
        rows = shard_batch({"x": x, "w": w, **({"m": mask} if mask is not None else {})}, mesh)
        x, w, mask = rows["x"], rows["w"], rows.get("m")
    x = x.clone().requires_grad_()
    out = bn(x, mask)
    (out * w).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None:
        grads = [all_reduce_(g.clone(), mesh) for g in grads]
    return {"out": out.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def reduced_dgamma(backward):
    """`backward` (the hand-derived backward, its mesh the last positional
    argument) returning dgamma / dbeta summed over the ranks: the double
    count under the gradient all-reduce, as a control the checks must
    catch."""
    def wrapped(*args):
        grads = list(backward(*args))
        grads[4:] = global_sums(args[-1], *grads[4:])
        return tuple(grads)

    return wrapped


def sa_train_rank(mesh, inputs: dict, cache_dtype, control=False) -> dict:
    """ops/sa_train.sa_train on this rank's clouds (rows of u, sv, idx, the
    masks and dout; the parameters alike on every rank): the output, the
    statistics, the inputs' gradients of sum(out * dout) and the
    parameters' gradients summed over the ranks; and the same of the
    autograd plain version sa_train_plain. `control`: the hand-derived
    backward returns dgamma / dbeta reduced over the ranks
    (reduced_dgamma)."""
    from text2loc_tpu_torch.ops import sa_train as ops
    from text2loc_tpu_torch.ops.sa_train import sa_train, sa_train_plain

    if control:
        ops.sa_train_backward_plain = reduced_dgamma(ops.sa_train_backward_plain)
    per_cloud = ("u", "sv", "idx", "maskm", "maskf", "dout")
    rows = {k: inputs[k] for k in per_cloud}
    if mesh is not None:
        rows = shard_batch(rows, mesh)
    out = {}
    for name, fn in (("fused", sa_train), ("plain", sa_train_plain)):
        u, sv = (rows[k].clone().requires_grad_() for k in ("u", "sv"))
        params = [inputs[k].clone().requires_grad_()
                  for k in ("w2", "b2", "g1", "be1", "g2", "be2")]
        y, stats = fn(u, sv, *params, rows["idx"], rows["maskm"].bool(), rows["maskf"].bool(),
                      cache_dtype=cache_dtype, mesh=mesh)
        (y * rows["dout"]).sum().backward()
        grads = [p.grad for p in params]
        if mesh is not None:
            grads = [all_reduce_(g.clone(), mesh) for g in grads]
        out[name] = {"out": y.detach(), "stats": [s.detach() for s in stats], "du": u.grad,
                     "dsv": sv.grad, "dparams": grads}
    return out


def retrieval_rank(mesh, gallery, texts, k) -> dict:
    """sharded_topk_retrieval of the gallery, and eval_retrieval over a
    seeded model and scene with its gallery sharded."""
    from text2loc_tpu_torch.parallel.retrieval import sharded_topk_retrieval

    scores, ids = sharded_topk_retrieval(gallery, texts, k, mesh)
    return {"scores": scores, "ids": ids, "eval": eval_model(mesh)}


def eval_model(mesh=None):
    """eval_retrieval of model_of's coarse weights over a 7-cell scene."""
    from text2loc_tpu_torch.evaluation.retrieval import eval_retrieval

    cfg = cfg_of()
    model = model_of(cfg, "coarse").eval()
    return eval_retrieval(scene(cfg, num_cells=7, num_poses=20, seed=4), model,
                          embedder(cfg), cfg, top_k=(1, 3, 5), device="cpu", mesh=mesh)


def trainer_rank(mesh, kind, workdir) -> dict:
    """One epoch of train_coarse / train_fine with a validation split and
    checkpoints in `workdir`: the epoch rows, the step losses and the best
    state."""
    from text2loc_tpu_torch.training.coarse import train_coarse
    from text2loc_tpu_torch.training.fine import train_fine

    cfg = cfg_of(batch=4, epochs=1)
    train = train_coarse if kind == "coarse" else train_fine
    best, _, logger = train(cfg, scene(cfg, num_poses=16, seed=1),
                            scene(cfg, num_poses=8, seed=1, pose_seed=9), embedder(cfg),
                            workdir=workdir, mesh=mesh, device="cpu")
    return {"history": dict(logger.history), "steps": [s["loss"] for s in logger.steps],
            "best": best}


def localizer_queries(cfg, data):
    q = np.arange(10) % data.num_poses
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    text = embedder(cfg).embed(*(torch.as_tensor(a) for a in args))
    return args, (text.token_embeds.numpy(), text.token_mask.numpy(),
                  text.sentence_mask.numpy())


def localizer_rank(mesh, cache_path=None) -> dict:
    """The Localizer's paths over a 7-cell scene with model_of's weights:
    cached localize (built with `cache_path`, then again from the file),
    localize_embedded, and the stepwise path."""
    from text2loc_tpu_torch.serving import Localizer

    cfg = cfg_of()
    data = scene(cfg, num_cells=7, num_poses=12, seed=2)
    coarse, fine = model_of(cfg, "coarse"), model_of(cfg, "fine")
    args, embedded = localizer_queries(cfg, data)

    def make(**kw):
        return Localizer(data, coarse, fine, embedder(cfg), cfg, top_k=5, mesh=mesh,
                         device="cpu", **kw)

    loc = make(cache_path=cache_path)
    out = {"cached": loc.localize(*args), "embedded": loc.localize_embedded(*embedded),
           "stepwise": make(precompute_fine=False).localize(*args),
           "rows": (loc.gallery.shape[0], loc.fine_emb.shape[0], loc.bbox.shape[0])}
    if cache_path is not None:
        out["from_cache"] = make(cache_path=cache_path).localize(*args)
    return out


def nt_xent_rank(mesh, z_i, z_j, temperature) -> dict:
    """training/losses.nt_xent on this rank's rows of both views [B, D]
    (numpy, every rank alike), or on all of them without a mesh: the loss
    and the gradients of the rows taken."""
    from text2loc_tpu_torch.training.losses import nt_xent

    rows = slice(None)
    if mesh is not None:
        b = len(z_i) // mesh.size
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    zi = torch.tensor(z_i[rows], requires_grad=True)
    zj = torch.tensor(z_j[rows], requires_grad=True)
    loss = nt_xent(zi, zj, temperature, mesh=mesh)
    loss.backward()
    return {"loss": loss.detach(), "grad_i": zi.grad, "grad_j": zj.grad}
