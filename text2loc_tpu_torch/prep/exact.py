"""Float64 device arithmetic that rounds as numpy does.

The prep's decisions (which voxel, which closest point, which location is
close, which points are DBSCAN neighbours) compare float64 values that the
JAX package computes in numpy. Torch reproduces them bit for bit when every
operation is a separate correctly rounded IEEE operation, which needs two
precautions:

* division by a Python scalar on a CUDA tensor is a multiplication by the
  reciprocal in PyTorch (one rounding more), so divisors are tensors on the
  operand's device;
* torch.sqrt of a CPU float64 tensor goes through MKL's vector math, which
  is not correctly rounded; on the card sqrt is IEEE-exact, and on the CPU
  the port takes numpy's.

np.linalg.norm over three coordinates is sqrt((dx*dx + dy*dy) + dz*dz):
three products, two sums in that order, then the root (`norm3`).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The torch device the prep runs on; "cuda" without a card raises
    (there is no fallback to the CPU: pass "cpu" for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"prep on {device!r}: no CUDA card; pass --device cpu "
                           "to run on the CPU")
    return dev


def div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b with b as a tensor on a's device (true division)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float64 tensor."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def sumsq3(d: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz over the last axis of [..., 3]."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def norm3(d: torch.Tensor) -> torch.Tensor:
    """np.linalg.norm(d, axis=-1) for [..., 3] float64, bit for bit."""
    return sqrt(sumsq3(d))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
