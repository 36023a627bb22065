"""ops/sa_train.near_ties and the masked form of the training SA backward's
check, on the CPU.

chip_smoke.py (phase 3) and tests/test_torch_port_cuda.py hold the card's
backward against sa_train_backward_plain by relative L2 error (1e-3 in
f32, norms floored at 1e-3 x the largest gradient norm), both fed dout with
zeros at the (cloud, center, column) pairs near_ties marks: there the
neighbour max's winner is not settled beyond f32 rounding, and either side
may move that pair's whole dout to another edge. Here, at small seeded
levels: near_ties marks planted ties and spares clear winners; at planted
near-ties the f32 plain backward and the same function in f64 pick other
winners, which the unmasked check sees and the masked check does not; and
a planted 1% error at the centers without a marked pair still fails the
masked check at the same limit.
"""

import numpy as np
import torch

from test_torch_port_sa_train_split import _level, _rel_l2, backward
from text2loc_tpu_torch.ops.sa_train import TIE_RTOL, near_ties, sa_train_backward_plain

REL_L2_F32 = 1e-3      # chip_smoke.py / tests/test_torch_port_cuda.py


def test_near_ties_marks_planted_ties_and_spares_clear_winners():
    """One center of four edges over points u = e (sv = 0), BN1 and BN2 the
    identity, so y2 = z = h1 W2 + b2 per column: a near-tie (relative gap
    1e-7), an exact tie (two edges on one point), a clear winner, a winner
    2^-22 above the ReLU's kink where its terms are of size 2, and a
    column whose edges are all below 0; a second center has no valid edge."""
    u = torch.tensor([[[1.0, 0.0, 0.0, 0.0], [1.0, 1e-7, 0.0, 0.0],
                       [0.5, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]])
    sv = torch.zeros(1, 2, 4)
    idx = torch.tensor([[[0, 1, 2, 3], [0, 1, 2, 3]]], dtype=torch.int32)
    maskm = torch.tensor([[[True] * 4, [False] * 4]])
    w2 = torch.tensor([[1.0, 1.0, 0.0, 0.0, -1.0],
                       [1.0, 0.0, 0.0, 0.0, -1.0],
                       [0.0, 0.0, 0.0, 0.0, -1.0],
                       [0.0, 0.0, 1.0, 1.0, -1.0]])
    aux1 = torch.zeros(8, 4)
    aux1[0] = 1.0
    aux2 = torch.zeros(8, 5)
    aux2[0] = 1.0
    aux2[6, 3] = -(1.0 - 2.0 ** -22)
    aux2[6, 4] = -0.25
    ties = near_ties(u, sv, w2, idx, maskm, aux1, aux2, torch.float32)
    assert ties.shape == (1, 2, 5) and ties.dtype == torch.bool
    assert ties[0, 0].tolist() == [True, True, False, True, False]
    assert not ties[0, 1].any()
    # The near-tie lies inside the limit, the clear winner far outside it.
    assert 1e-7 <= TIE_RTOL <= 1e-5
    # bf16 operands: the 1e-7 step of u is rounded away, an exact tie.
    assert near_ties(u, sv, w2, idx, maskm, aux1, aux2, torch.bfloat16)[0, 0, 0]


def _planted(seed):
    """A level (H 64 -> 64, K = 32, P = 64) whose points 1, 3, ..., 15 are
    their even neighbours with one component a step of one f32 ulp away,
    and whose every fourth center takes such a point and its twin as its
    first two edges (the other edges lie on distinct points of 16-63):
    wherever a twin wins a column the other is within rounding of it."""
    u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout = _level(seed, h1=64, h2=64)
    u[:, 1:16:2] = u[:, 0:16:2]
    u[:, 1:16:2, 0] = torch.nextafter(u[:, 1:16:2, 0], torch.tensor(float("inf")))
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(16 + np.argsort(rng.random(idx.shape[:2] + (48,)), -1)[
        ..., :idx.shape[2]].astype(np.int32))
    idx[:, ::4, 0] = 2 * (idx[:, ::4, 0] % 8)
    idx[:, ::4, 1] = idx[:, ::4, 0] + 1
    maskm[:, ::4, :2] = True
    maskm[0, 0] = False
    maskf = maskm.clone()
    maskf[-1] = False
    return u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout


def _f64(args):
    return tuple(a.double() if a.is_floating_point() else a for a in args)


def test_masked_check_is_blind_to_near_ties_only():
    args = _planted(3)
    u, sv, w2, idx, maskm, maskf, aux1, aux2, n1, dout = args
    ties = near_ties(u, sv, w2, idx, maskm, aux1, aux2, torch.float32)
    assert 0 < int(ties.sum()) < ties.numel() // 8
    ref = backward(*_f64(args), mm=torch.matmul)
    got = sa_train_backward_plain(*args)
    # Unmasked, the f32 backward's other winners at the near-ties fail the
    # limit against the same function in f64.
    assert max(_rel_l2(got, ref)) > REL_L2_F32
    masked = args[:-1] + (dout.masked_fill(ties, 0.0),)
    ref_m = backward(*_f64(masked), mm=torch.matmul)
    got_m = sa_train_backward_plain(*masked)
    assert max(_rel_l2(got_m, ref_m)) <= REL_L2_F32 / 100
    # A 1% error in dsv at the centers without a marked pair fails the
    # masked check at the same limit.
    clear = ~ties.any(-1)
    assert clear.sum() > clear.numel() // 2
    dsv = got_m[1].clone()
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(dsv.shape).astype(
        np.float32)) * clear[..., None]
    dsv += 0.01 * dsv.norm() * noise / noise.norm()
    rels = _rel_l2((got_m[0], dsv) + tuple(got_m[2:]), ref_m)
    assert rels[1] > REL_L2_F32
    assert max(rels[:1] + rels[2:]) <= REL_L2_F32 / 100
