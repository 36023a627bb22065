"""Per-cloud row gather [N, P, C] x [N, Q] -> [N, Q, C] and its
differentiable form: the plain PyTorch versions and the dispatch (port of
text2loc_tpu/ops/pallas_gather.py: gather_rows_pallas, gather_rows_grad).

The TPU kernels gather through a one-hot matrix on the MXU; the result is
exact either way, so the port's plain versions are take-along-axis
(torch.gather) and, for the backward, a scatter-add. The plain scatter-add
is torch.Tensor.index_add_ into zeros over the flattened [N * P, C] rows,
in f32: on the CPU it adds the rows in index order (increasing q per
point), the order of the CUDA kernel; on a CUDA tensor index_add_ adds with
atomics in no fixed order.
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_gather


def gather_rows_plain(values, idx):
    """values [N, P, C], idx [N, Q] -> [N, Q, C]."""
    n, _, c = values.shape
    return torch.gather(values, 1, idx.long()[..., None].expand(n, idx.shape[1], c))


def scatter_rows_plain(g, idx, p: int):
    """g [N, Q, C], idx [N, Q] -> [N, P, C] in g's dtype: row p sums the
    rows of g whose index is p (summed in f32)."""
    n, q, c = g.shape
    flat = (idx.long() + torch.arange(n, device=idx.device)[:, None] * p).reshape(-1)
    out = torch.zeros((n * p, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, flat, g.reshape(n * q, c).float())
    return out.reshape(n, p, c).to(g.dtype)


def _device_check(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no row gather for device {t.device}")


def gather_rows(values, idx):
    """The gather on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _device_check(values)
    if values.is_cuda:
        return cuda_gather.gather_rows_cuda(values.contiguous(),
                                            idx.to(torch.int32).contiguous())
    return gather_rows_plain(values, idx)


def scatter_rows(g, idx, p: int):
    """The scatter-add on the tensors' device (kernel or plain version)."""
    _device_check(g)
    if g.is_cuda:
        return cuda_gather.scatter_rows_cuda(g.contiguous(), idx.to(torch.int32).contiguous(),
                                             p)
    return scatter_rows_plain(g, idx, p)


class _GatherRowsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.p = values.shape[1]
        return gather_rows(values, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.p), None


def gather_rows_grad(values, idx):
    """Differentiable gather [N, P, C] x [N, Q] -> [N, Q, C]: forward the
    gather kernel, backward the scatter-add kernel (exact over duplicate
    indices); the plain versions on the CPU."""
    return _GatherRowsGrad.apply(values, idx)
