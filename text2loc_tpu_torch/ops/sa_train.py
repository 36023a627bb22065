"""One SA level's training forward with batch-statistic BatchNorm and its
hand-derived backward: the plain PyTorch versions, and the autograd
function that runs the CUDA kernels on the card (port of
text2loc_tpu/ops/pallas_sa_train.py: sa_train_reference, sa_train_fused).

    e[n,s,k] = round(u[n, idx[n,s,k]]) - sv[n,s]
    BN1 over maskf edges (batch statistics) -> a1, c1
    h1 = relu(e * a1 + c1)
    z  = round(h1) @ round(W2) + b2
    BN2 over maskf edges -> a2, c2
    h2 = relu(z * a2 + c2)
    out[n,s] = max over maskm k of h2   (a row without valid slots -> 0)

round() goes through the compute dtype (the identity for f32; bf16 rounds
where the TPU kernel rounds), every sum is f32. The statistics are the TPU
kernel's: mean = sum/n, biased variance = max(sum_sq/n - mean^2, 0), with
n = max(#maskf edges, 1). maskf (valid edges of real objects) masks the
statistics, maskm (valid edges) the neighbour max.

The cached-edge variant of the JAX kernel (_forward_e / _backward_e) at
cache dtype f32 computes the same function as its recompute variant, so
both are this one function (cache_dtype None or float32). At cache dtype
bf16 (the token "e") e is rounded to bf16 where it is formed,

    e[n,s,k] = bf16(round(u[n, idx[n,s,k]]) - sv[n,s])

and every later quantity (the BN1 statistics, h1, z, the backward) is
taken of the rounded e; the gradients pass the rounding unchanged (du is
the scatter of de, dsv = -sum_k de). On the card no cache is written:
every pass recomputes e and rounds it the same way (csrc/sa_train_e_fwd.cu,
sa_train_e_bwd.cu), which gives the passes the e a cache would hold.

Under a data-parallel mesh (parallel/mesh.py) each rank holds its own
clouds and the statistics are the global batch's: the forward's sums
(sum, sum of squares and the count n) are all-reduced between its passes,
the backward's correction sums (A = sum dy, B = sum dy * yhat) before they
are divided by n. The returned dgamma / dbeta are the rank's local sums,
like dW2 and db2: the step's all-reduce of the parameter gradients sums
them once (the JAX kernel's rule, pallas_sa_train.py:1008-1012).
"""

from __future__ import annotations

import torch

from text2loc_tpu_torch.ops import cuda_sa_train
from text2loc_tpu_torch.ops.masked import masked_max
from text2loc_tpu_torch.parallel.mesh import global_sums

NEG = -1.0e30
_AUX_ROWS = 8     # a, c, mean, inv, A/n, B/n, b2 (aux2 only), unused


def _round(x, dtype):
    """x rounded through `dtype` in value, the identity in the backward."""
    if dtype == torch.float32:
        return x
    return x + (x.to(dtype).float() - x).detach()


def _edge_dtype(cache_dtype):
    """The dtype e is rounded through: bf16 for the bf16 cache, else f32
    (None and float32 are the recompute function)."""
    if cache_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"cache_dtype {cache_dtype}: expected None, float32 or bfloat16")
    return torch.bfloat16 if cache_dtype == torch.bfloat16 else torch.float32


def _stats(x, mf, n1, mesh=None):
    """(mean, biased variance) over the maskf edges (of every rank under a
    mesh): the TPU kernel's one-pass formulas."""
    dims = tuple(range(x.ndim - 1))
    s1, s2 = global_sums(mesh, (x * mf).sum(dims), (x * x * mf).sum(dims))
    m = s1 / n1
    return m, torch.clamp(s2 / n1 - m * m, min=0.0)


def _count(maskf, mesh):
    """n = max(#maskf edges, 1), over every rank under a mesh."""
    (n,) = global_sums(mesh, maskf.float().sum())
    return torch.clamp(n, min=1.0)


def _affine(m, v, gamma, beta, eps):
    """(a, c, inv) of the BN affine y = x * a + c."""
    inv = torch.rsqrt(v + eps)
    a = gamma * inv
    return a, beta - m * a, inv


def _aux(rows, width, device):
    aux = torch.zeros((_AUX_ROWS, width), dtype=torch.float32, device=device)
    for i, r in rows.items():
        aux[i] = r
    return aux


def _edges(u, sv, idx, cdt, edt=torch.float32):
    """e [N, S, K, H1] f32, rounded through the edge dtype `edt`."""
    n, p, h1 = u.shape
    s, k = idx.shape[1:]
    flat = idx.reshape(n, s * k, 1).long().expand(n, s * k, h1)
    g = torch.gather(_round(u.float(), cdt), 1, flat).reshape(n, s, k, h1)
    return _round(g - sv.float()[:, :, None, :], edt)


def sa_train_plain(u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf,
                   eps: float = 1e-5, compute_dtype=torch.float32, cache_dtype=None,
                   mesh=None):
    """(out [N, S, H2] f32, (mean1, var1, mean2, var2, count)) in plain
    torch, differentiable by autograd (the statistics too); under `mesh`
    the statistics and the count are the global batch's."""
    cdt = compute_dtype
    mf = maskf.float()[..., None]
    n1 = _count(maskf, mesh)
    e = _edges(u, sv, idx, cdt, _edge_dtype(cache_dtype))
    m1, v1 = _stats(e, mf, n1, mesh)
    a1, c1, _ = _affine(m1, v1, g1, be1, eps)
    h1 = torch.relu(e * a1 + c1)
    z = _round(h1, cdt) @ _round(w2.float(), cdt) + b2
    m2, v2 = _stats(z, mf, n1, mesh)
    a2, c2, _ = _affine(m2, v2, g2, be2, eps)
    out = masked_max(torch.relu(z * a2 + c2), maskm, dim=2)
    return out, (m1, v1, m2, v2, n1)


def sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout,
                            compute_dtype=torch.float32, cache_dtype=None, mesh=None):
    """The hand-derived backward in plain torch (the CUDA backward's
    yardstick): (du, dsv, dW2, db2, dgamma1, dbeta1, dgamma2, dbeta2) given
    the forward's aux rows (a, c, mean, inv; aux2 row 6 = b2) and count.

        dh2 = dout * eq / cnt,  dy2 = dh2 * [y2 > 0]
        dz  = a2 * (dy2 - maskf * (A2/n + yhat2 * B2/n))
        dh1 = round(dz) @ round(W2)^T,  dy1 = dh1 * [y1 > 0]
        de  = a1 * (dy1 - maskf * (A1/n + yhat1 * B1/n))
        du  = scatter of round(de) at idx,  dsv = -sum_k de
        dW2 = round(h1)^T round(dz),  db2 = sum dz
    with A = sum dy, B = sum dy * yhat over ALL edges (dbeta, dgamma).
    Under `mesh`, n1 is the global count, A and B are summed over the
    ranks for dz and de, and the returned dgamma / dbeta are the local
    sums."""
    cdt = compute_dtype
    n, p, h1w = u.shape
    s, k = idx.shape[1:]
    dims = (0, 1, 2)
    mf = maskf.float()[..., None]
    mm = maskm[..., None]
    e = _edges(u, sv, idx, cdt, _edge_dtype(cache_dtype))
    y1 = e * aux1[0] + aux1[1]
    h1 = torch.relu(y1)
    w2c = w2.float().to(cdt).float()
    z = h1.to(cdt).float() @ w2c + aux2[6]
    y2 = z * aux2[0] + aux2[1]
    filled = torch.where(mm, torch.relu(y2), torch.full((), NEG, device=u.device))
    mx = filled.amax(dim=2, keepdim=True)
    eq = ((filled >= mx) & mm).float()
    cnt = torch.clamp(eq.sum(dim=2, keepdim=True), min=1.0)
    dh2 = dout.float()[:, :, None, :] * eq / cnt
    dy2 = dh2 * (y2 > 0).float()
    yhat2 = (z - aux2[2]) * aux2[3]
    dbe2, dg2 = dy2.sum(dims), (dy2 * yhat2).sum(dims)
    ga2, gb2 = global_sums(mesh, dbe2, dg2)
    dz = aux2[0] * (dy2 - mf * (ga2 / n1 + yhat2 * (gb2 / n1)))
    dzc = dz.to(cdt).float()
    dh1 = dzc @ w2c.t()
    dy1 = dh1 * (y1 > 0).float()
    yhat1 = (e - aux1[2]) * aux1[3]
    dbe1, dg1 = dy1.sum(dims), (dy1 * yhat1).sum(dims)
    ga1, gb1 = global_sums(mesh, dbe1, dg1)
    de = aux1[0] * (dy1 - mf * (ga1 / n1 + yhat1 * (gb1 / n1)))
    dw2 = h1.to(cdt).float().reshape(-1, h1w).t() @ dzc.reshape(-1, dzc.shape[-1])
    db2 = dz.sum(dims)
    du = torch.zeros((n, p, h1w), dtype=torch.float32, device=u.device)
    du.scatter_add_(1, idx.reshape(n, s * k, 1).long().expand(n, s * k, h1w),
                    de.to(cdt).float().reshape(n, s * k, h1w))
    dsv = -de.sum(dim=2)
    return du, dsv, dw2, db2, dg1, dbe1, dg2, dbe2


# Where the neighbour max's winner is not settled beyond f32 rounding. The
# pre-activation of an (edge, column) is y2 = a2 (sum_k h1_k w2_kc + b2) +
# c2, a sum of H1 <= 256 products; scale = |a2| (sum_k |h1_k w2_kc| +
# |b2_c|) is the size of its terms. Summed in f32 in any order (FMAs on the
# FP32 pipes or in cuBLAS; 3xTF32 per-k8 partials, whose dropped lo.lo
# terms are 2^-22 of a product), the i-th rounding errs by at most 2^-25 of
# the running sum S_i (round to nearest). With terms of either sign S_i
# grows as sqrt(i) while the scale grows as i, so the H1 roundings add up,
# as a random walk, to about 2^-25 sqrt(sum_i S_i^2) ~ 2^-26 of the scale
# whatever H1 (the worst case, every S_i at the scale, is H1 2^-25 =
# 2^-17 at H1 = 256, but the smoke's levels never come near it). Two ways
# of computing the winner's and the runner-up's y2 differ by four such
# errors, 2^-25; the limit takes 16 times that, 2^-21 = 4.8e-7 of the
# scale. It covers the smoke's SA2 flip (relative gap 3.2e-7) and the
# widest flip scripts/probe_torch_sa_train_ties.py finds; twice the limit
# would mark more than 1e-5 of a level's pairs, which the smoke's check
# refuses (the count grows in proportion to the limit).
TIE_RTOL = 2.0 ** -21
_TIE_CHUNK = 1 << 24   # f64 elements of one [clouds, S, K, H] block of near_ties


def near_ties(u, sv, w2, idx, maskm, aux1, aux2, compute_dtype, cache_dtype=None,
              rtol: float = TIE_RTOL):
    """bool [N, S, H2]: the (cloud, center, column) pairs whose neighbour-max
    winner is not settled beyond f32 rounding, at the forward's aux rows.
    e and h1 are formed as sa_train_backward_plain forms them (f32, rounded
    to the compute dtype, e to bf16 under the bf16 cache), z = h1 W2 + b2
    and y2 = z a2 + c2 in f64. A pair is marked where, over its maskm
    edges, the largest relu(y2) is > 0 and exceeds the second largest by
    at most rtol x scale, or the largest y2 lies within rtol x scale of 0
    (the ReLU's kink), scale = |a2| (sum_k |h1_k w2_kc| + |b2_c|) at the
    winning edge. A pair whose edges all have y2 < 0 passes no gradient,
    whichever edge wins, and is not marked. For the checks only, never the
    main path; an rtol other than TIE_RTOL serves the ties probe's sweep."""
    cdt = compute_dtype
    n, _, h1w = u.shape
    s, k = idx.shape[1:]
    h2w = w2.shape[1]
    w2c = w2.float().to(cdt).double()
    a2, c2, b2 = (aux2[i].double() for i in (0, 1, 6))
    ties = torch.zeros((n, s, h2w), dtype=torch.bool, device=u.device)
    step = max(1, _TIE_CHUNK // max(1, s * k * max(h1w, h2w)))
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        e = _edges(u[sl], sv[sl], idx[sl], cdt, _edge_dtype(cache_dtype))
        h1 = torch.relu(e * aux1[0] + aux1[1]).to(cdt).double()
        y2 = torch.where(maskm[sl][..., None], (h1 @ w2c + b2) * a2 + c2,
                         torch.full((), -torch.inf, dtype=torch.float64, device=u.device))
        scale = a2.abs() * (h1 @ w2c.abs() + b2.abs())
        if k > 1:
            top, arg = torch.topk(y2, 2, dim=2)
            first, second = top[:, :, 0], top[:, :, 1]
        else:
            first, arg = y2[:, :, 0], torch.zeros_like(y2[:, :, :1], dtype=torch.long)
            second = torch.full_like(first, -torch.inf)
        tol = rtol * torch.gather(scale, 2, arg[:, :, :1]).squeeze(2)
        kink = torch.isfinite(first) & (first.abs() <= tol)
        gap = (first > 0) & (first - second.clamp(min=0.0) <= tol)
        ties[sl] = kink | gap
    return ties


def _forward_plain(u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, eps, cdt,
                   cache_dtype, mesh):
    out, (m1, v1, m2, v2, n1) = sa_train_plain(u, sv, w2, b2, g1, be1, g2, be2, idx,
                                               maskm, maskf, eps, cdt, cache_dtype, mesh)
    a1, c1, inv1 = _affine(m1, v1, g1, be1, eps)
    a2, c2, inv2 = _affine(m2, v2, g2, be2, eps)
    aux1 = _aux({0: a1, 1: c1, 2: m1, 3: inv1}, u.shape[-1], u.device)
    aux2 = _aux({0: a2, 1: c2, 2: m2, 3: inv2, 6: b2}, w2.shape[1], u.device)
    return out, (m1, v1, m2, v2, n1), aux1, aux2


def forward_cuda(level: cuda_sa_train.Level, b2, g1, be1, g2, be2, maskf, eps,
                 mesh=None):
    """The forward on the card: three kernel passes with the BN
    finalization between them (the sums all-reduced first under `mesh`).
    Returns (out, stats, aux1, aux2)."""
    aux1 = _aux({}, level.h1, maskf.device)
    aux2 = _aux({6: b2}, level.h2, maskf.device)
    acc1, n1 = global_sums(mesh, level.stats(1, aux1, aux2), maskf.float().sum())
    n1 = torch.clamp(n1, min=1.0)
    m1 = acc1[0] / n1
    v1 = torch.clamp(acc1[1] / n1 - m1 * m1, min=0.0)
    a1, c1, inv1 = _affine(m1, v1, g1, be1, eps)
    aux1[0], aux1[1], aux1[2], aux1[3] = a1, c1, m1, inv1
    (acc2,) = global_sums(mesh, level.stats(2, aux1, aux2))
    m2 = acc2[0] / n1
    v2 = torch.clamp(acc2[1] / n1 - m2 * m2, min=0.0)
    a2, c2, inv2 = _affine(m2, v2, g2, be2, eps)
    aux2[0], aux2[1], aux2[2], aux2[3] = a2, c2, m2, inv2
    return level.out(aux1, aux2), (m1, v1, m2, v2, n1), aux1, aux2


def backward_cuda(level: cuda_sa_train.Level, aux1, aux2, n1, dout, mesh=None):
    """The backward on the card: three kernel passes, the correction sums
    between them (all-reduced first under `mesh`; dgamma / dbeta stay the
    local sums). Returns the grads in sa_train_backward_plain's order."""
    dout = dout.float().contiguous()
    acc2 = level.bwd_stats(aux1, aux2, dout)
    (glob2,) = global_sums(mesh, acc2)
    aux2 = aux2.clone()
    aux2[4], aux2[5] = glob2[0] / n1, glob2[1] / n1
    acc1, dw2, db2 = level.bwd_mid(aux1, aux2, dout)
    (glob1,) = global_sums(mesh, acc1)
    aux1 = aux1.clone()
    aux1[4], aux1[5] = glob1[0] / n1, glob1[1] / n1
    du, dsv = level.bwd_in(aux1, aux2, dout)
    return du, dsv, dw2, db2, acc1[1], acc1[0], acc2[1], acc2[0]


class _SATrain(torch.autograd.Function):
    """The fused level with the hand-derived backward: CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, eps, cdt,
                cache_dtype, mesh):
        if u.is_cuda:
            level = cuda_sa_train.Level(u.contiguous(), sv.contiguous(),
                                        w2.contiguous(), idx.to(torch.int32).contiguous(),
                                        maskm.contiguous(), maskf.contiguous(), cdt,
                                        cache_dtype)
            out, stats, aux1, aux2 = forward_cuda(level, b2, g1, be1, g2, be2, maskf, eps,
                                                  mesh)
            ctx.level = level
        elif u.device.type == "cpu":
            out, stats, aux1, aux2 = _forward_plain(u, sv, w2, b2, g1, be1, g2, be2, idx,
                                                    maskm, maskf, eps, cdt, cache_dtype,
                                                    mesh)
            ctx.level = None
        else:
            raise ValueError(f"no SA training level for device {u.device}")
        ctx.cdt, ctx.cache_dtype, ctx.mesh = cdt, cache_dtype, mesh
        ctx.save_for_backward(u, sv, w2, idx, maskm, maskf, aux1, aux2, stats[4])
        ctx.mark_non_differentiable(*stats)
        return (out,) + tuple(stats)

    @staticmethod
    def backward(ctx, dout, *_stat_grads):
        u, sv, w2, idx, maskm, maskf, aux1, aux2, n1 = ctx.saved_tensors
        if ctx.level is not None:
            grads = backward_cuda(ctx.level, aux1, aux2, n1, dout, ctx.mesh)
        else:
            grads = sa_train_backward_plain(u, sv, w2, idx, maskm, maskf, aux1, aux2, n1,
                                            dout, ctx.cdt, ctx.cache_dtype, ctx.mesh)
        return grads + (None,) * 7


def sa_train(u, sv, w2, b2, g1, be1, g2, be2, idx, maskm, maskf, eps: float = 1e-5,
             compute_dtype=torch.float32, cache_dtype=None, mesh=None):
    """One SA level's training forward (out [N, S, H2] f32, (mean1, var1,
    mean2, var2, count)); gradients by the hand-derived backward. The CUDA
    kernels run for CUDA tensors (no fallback), the plain versions for CPU
    tensors. u [N, P, H1] = concat(x, pos) @ W1 + b1, sv [N, S, H1] =
    centers @ W1[pos rows], idx [N, S, K], maskm / maskf [N, S, K] bool.
    cache_dtype: None or float32 (the recompute function), or bfloat16 (e
    rounded to bf16, the JAX kernel's bf16 cache). `mesh`: a data-parallel
    Mesh over which the statistics are global (the module docstring)."""
    if _edge_dtype(cache_dtype) == torch.float32:
        cache_dtype = None
    out, *stats = _SATrain.apply(u, sv, w2, b2, g1, be1, g2, be2, idx, maskm.bool(),
                                 maskf.bool(), eps, compute_dtype, cache_dtype, mesh)
    return out, tuple(stats)
