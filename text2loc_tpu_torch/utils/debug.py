"""Numerical sanitizers, opt-in (port of text2loc_tpu/utils/debug.py).

enable_nan_debugging turns on autograd's anomaly mode (a backward op that
makes a NaN raises with the forward op's traceback) and makes the train
steps of training/steps.py check the loss before the backward and every
gradient after it (after the all-reduce under a mesh, so every rank
raises alike): a non-finite value raises FloatingPointError naming the
first non-finite parameter. checkify_step wraps a step so that a
non-finite output raises.

The JAX package's enable_disable_jit has no counterpart: the port runs
eagerly and compiles no program.
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.parallel.mesh import all_reduce_

# Like torch's anomaly mode and jax_debug_nans, a process-wide switch.
_NAN_DEBUGGING = [False]


def enable_nan_debugging(enable: bool = True) -> None:
    """Anomaly mode on (off), and the train steps' checks with it."""
    torch.autograd.set_detect_anomaly(enable)
    _NAN_DEBUGGING[0] = enable


def nan_debugging() -> bool:
    return _NAN_DEBUGGING[0]


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def first_nonfinite(named) -> str | None:
    """The name of the first (name, tensor) pair holding a NaN or an inf."""
    for name, t in named:
        if t is not None and not _finite(t):
            return name
    return None


def check_loss(loss: torch.Tensor, model: torch.nn.Module, mesh=None) -> None:
    """Raise FloatingPointError if `loss` is not finite (under a mesh: the
    sum of every rank's share, so that the ranks raise alike), naming the
    first parameter that holds a non-finite value (if one does)."""
    if mesh is not None:
        loss = all_reduce_(loss.detach().clone(), mesh)
    if _finite(loss):
        return
    bad = first_nonfinite(model.named_parameters())
    where = f"; first non-finite parameter: {bad}" if bad else "; every parameter finite"
    raise FloatingPointError(f"non-finite loss {float(loss)}{where}")


def check_grads(model: torch.nn.Module) -> None:
    """Raise FloatingPointError naming the first parameter whose gradient
    holds a NaN or an inf."""
    bad = first_nonfinite((n, p.grad) for n, p in model.named_parameters())
    if bad is not None:
        raise FloatingPointError(f"non-finite gradient of parameter {bad}")


def checkify_step(step_fn):
    """Wrap a step (-> dict of metrics) so that a non-finite tensor among
    its outputs raises FloatingPointError naming the output."""

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        bad = first_nonfinite((k, v) for k, v in out.items() if isinstance(v, torch.Tensor))
        if bad is not None:
            raise FloatingPointError(f"non-finite step output {bad!r}: {out[bad]}")
        return out

    return wrapped
