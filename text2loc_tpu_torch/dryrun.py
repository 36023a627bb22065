"""A dry run of the data-parallel paths on CPU ranks, and the launcher it
uses (port of __graft_entry__.py's dryrun_multichip).

run_ranks starts `world` processes (spawn), each one rank of a
torch.distributed group over a FileStore in a fresh temporary directory,
runs fn(mesh, *args) on every rank and returns each rank's result. A rank
that fails or a run past its timeout kills every rank and raises.

dryrun_multichip(n) runs, on n gloo ranks on the CPU at the small test
config: one DP coarse step (the sa_train levels with all-reduced
statistics, and again on the plain branch, fused_train="0"), one DP
fine step, and the sharded serve; each is checked on every rank against
the same computation on one rank without a mesh.

    python -m text2loc_tpu_torch.dryrun 2
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch


def _rank_main(rank, world, store, out_dir, fn, args, backend, device, threads):
    import torch.distributed as dist

    from text2loc_tpu_torch.parallel.mesh import make_mesh

    if threads:
        torch.set_num_threads(threads)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        mesh = make_mesh(world, device=device, backend=backend,
                         init_method=f"file://{store}", rank=rank, world_size=world)
        try:
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, args=(), timeout: float = 120.0, backend: str = "gloo",
              device="cpu", threads=None) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank world - 1]: `world` spawned
    processes, one rank each of a `backend` group on `device` (several
    ranks may share one CUDA device under gloo). `fn` must be importable
    by name (a module-level function) and its result picklable. `threads`:
    torch.set_num_threads in each rank. Raises RuntimeError with the first
    failed rank's traceback, or TimeoutError past `timeout` seconds; either
    way every rank is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="t2l_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, tmp, fn, tuple(args), backend,
                                   str(device), threads), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(_failure(tmp, failed[0], procs[failed[0]].exitcode))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running "
                                       f"after {timeout} s")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(_failure(tmp, failed[0], procs[failed[0]].exitcode))
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)


def _failure(tmp, rank, code) -> str:
    path = os.path.join(tmp, f"rank{rank}.err")
    detail = open(path).read() if os.path.exists(path) else "(no traceback written)"
    return f"rank {rank} exited with code {code}:\n{detail}"


# ------------------------------------------------------------- the dry run


def _setup(batch_size):
    from text2loc_tpu_torch.config import small_test_config
    from text2loc_tpu_torch.data.arrays import MultiSceneArrays
    from text2loc_tpu_torch.data.synthetic import make_scene
    from text2loc_tpu_torch.models.text_embedding import HintTextEmbedder

    cfg = small_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch_size))
    m = cfg.model
    data = MultiSceneArrays([make_scene("0000", num_cells=6, num_poses=2 * batch_size,
                                        object_slots=m.object_size,
                                        num_points=m.pointnet.num_points,
                                        num_mentioned=m.num_mentioned)])
    return cfg, data, HintTextEmbedder.compositional(m.text_embed_dim, m.max_hint_tokens)


def _step(kind, cfg, emb, batch, mesh=None, fused_train=None):
    """(loss, {name: gradient}) of one train step of `kind` from the seeded
    weights, with the generator seeded alike; `batch` is this rank's rows
    under `mesh`; `fused_train` as build_model's."""
    from text2loc_tpu_torch.convert import build_model, init_weights
    from text2loc_tpu_torch.training import steps

    model = init_weights(build_model(cfg, kind, sa_mode="off", fused_train=fused_train),
                         torch.Generator().manual_seed(1))
    make_opt = steps.make_optimizer if kind == "coarse" else steps.make_fine_optimizer
    opt = make_opt(model.parameters(), cfg, steps_per_epoch=1)
    make = steps.make_coarse_train_step if kind == "coarse" else steps.make_fine_train_step
    step = make(model, emb, cfg, opt, torch.Generator().manual_seed(2), mesh=mesh)
    loss = float(step(batch)["loss"])
    return loss, {k: p.grad.clone() for k, p in model.named_parameters()
                  if p.grad is not None}, model


def _close(name, got, want, rtol=1e-4):
    err = abs(got - want) / max(abs(want), 1e-12)
    if not err <= rtol:
        raise AssertionError(f"{name}: {got} against {want} (rel {err})")


def _grads_close(name, got, want, rtol=1e-4):
    """Every gradient leaf within rel-L2 `rtol`; a leaf below 1e-6 of the
    global gradient norm (a BatchNorm-shift direction, whose exact gradient
    is 0) only has to stay below 10 times that floor."""
    floor = 1e-6 * float(torch.sqrt(sum(w.double().pow(2).sum() for w in want.values())))
    for k, w in want.items():
        if float(w.norm()) < floor:
            ok = float(got[k].norm()) < 10 * floor
        else:
            ok = float((got[k] - w).norm() / w.norm()) <= rtol
        if not ok:
            raise AssertionError(f"{name}: gradient {k} differs ({float(got[k].norm())} "
                                 f"against {float(w.norm())})")


def _dryrun_rank(mesh) -> dict:
    from text2loc_tpu_torch.parallel.mesh import shard_batch
    from text2loc_tpu_torch.serving import Localizer

    cfg, data, emb = _setup(2 * mesh.size)
    b = cfg.train.batch_size
    out = {}
    coarse = data.gather_coarse(np.arange(b), cfg.model.object_size)
    fine = data.gather_fine(np.arange(b), cfg.model.pad_size)
    for kind, batch in (("coarse", coarse), ("fine", fine)):
        want, want_g, model = _step(kind, cfg, emb, batch)
        got, got_g, _ = _step(kind, cfg, emb, shard_batch(batch, mesh), mesh)
        _close(f"{kind} loss", got, want)
        _grads_close(f"{kind} step", got_g, want_g)
        out[kind] = got
        out[kind + "_model"] = model
    plain, _, _ = _step("coarse", cfg, emb, shard_batch(coarse, mesh), mesh, fused_train="0")
    _close("coarse loss on the plain train branch", plain, out["coarse"])
    out["coarse_plain"] = plain

    q = np.arange(4)
    args = (data.hint_dir[q], data.hint_color[q], data.hint_label[q], data.hint_mask[q])
    kw = dict(top_k=3, device="cpu")
    dense = Localizer(data, out["coarse_model"], out.pop("fine_model"), emb, cfg, **kw)
    coarse_model = out.pop("coarse_model")
    sharded = Localizer(data, coarse_model, dense.fine_model, emb, cfg, mesh=mesh, **kw)
    rd, rs = dense.localize(*args), sharded.localize(*args)
    if not np.array_equal(rs.cell_indices, rd.cell_indices):
        raise AssertionError(f"sharded serve ids {rs.cell_indices} != dense {rd.cell_indices}")
    np.testing.assert_allclose(rs.position_w, rd.position_w, rtol=1e-4, atol=1e-4)
    out["serve_top1"] = rs.cell_indices[:, 0].tolist()
    return out


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """The dry run on `n_devices` gloo CPU ranks (one thread each); returns
    rank 0's {"coarse", "fine", "coarse_plain": global losses, "serve_top1":
    the sharded serve's top-1 cells}. Raises if a rank fails a check."""
    return run_ranks(_dryrun_rank, n_devices, timeout=timeout, threads=1)[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
