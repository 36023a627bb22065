"""The row gather's and FPS's host-side plans and kernel arithmetic, on the CPU.

The plans (ops/cuda_gather.gather_plan, ops/cuda_fps.fps_plan) are pure
functions: here they are held at every shape the port's paths give them,
and at the shapes beyond which they raise. The kernels themselves run only
on the card (tests/test_torch_port_cuda.py), but their index arithmetic is
emulated here in numpy, step for step as csrc/gather_rows.cu and
csrc/fps.cu do it, at small shapes: the staged gather's chunks, ragged head
and tail and incremental row stepping must write every output byte once
and reproduce torch.gather, with zero rows for indices outside [0, P); the
FPS variants' lane layouts, padding and argmax must give the plain
version's indices bit for bit, on tie-heavy and all-equal clouds too. The
plain FPS is also held against the Pallas kernel in interpret mode on such
clouds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2loc_tpu.ops.pallas_fps import farthest_point_sampling_pallas
from text2loc_tpu_torch.ops import _cuda, cuda_fps, cuda_gather
from text2loc_tpu_torch.ops.fps import farthest_point_sampling_plain
from text2loc_tpu_torch.ops.gather import gather_rows, gather_rows_plain

# (P, Q, C) of the paths' gathers: the gallery's SA levels (vmem_gather,
# P x 32 rows a cloud), the fine step's probe levels; the smoke's clouds.
GALLERY = [(256, 128 * 32, 6), (128, 64 * 32, 67), (64, 32 * 32, 131)]
PROBE = [(256, 128 * 32, 32), (128, 64 * 32, 128), (64, 32 * 32, 256)]


def _clouds(rng, n, p, kind):
    pts = rng.random((n, p, 3)).astype(np.float32)
    if kind == "ties":                 # duplicated points: exact distance ties
        pts[:, p // 2:] = pts[:, : p - p // 2]
    elif kind == "equal":              # a padded cloud: every point the same
        pts[:] = pts[:, :1]
    elif kind == "grid":               # integer grid: many equal distances
        pts = rng.integers(0, 3, (n, p, 3)).astype(np.float32)
    return pts


# --------------------------------------------------------------- FPS plan


@pytest.mark.parametrize("p,per_lane", [(1, 1), (31, 1), (32, 1), (33, 2), (64, 2),
                                        (65, 4), (255, 8), (256, 8), (257, 16), (512, 16),
                                        (513, 0), (14528, 0), (57984, 0)])
def test_fps_plan_variant_and_points_a_lane(p, per_lane):
    for s in {1, min(128, p), p}:
        plan = cuda_fps.fps_plan(p, s)
        assert plan.per_lane == per_lane
        if per_lane:
            assert 32 * per_lane >= p > 16 * per_lane or per_lane == 1
            assert plan.warps == cuda_fps.WARPS_PER_BLOCK
            assert plan.smem == 4 * plan.warps * (3 * p + s)
        else:
            assert plan.smem == 4 * p <= _cuda.SMEM_LIMIT - cuda_fps.BLOCK_STATIC_SMEM


def test_fps_plan_raises_beyond_what_the_kernels_take():
    largest = (_cuda.SMEM_LIMIT - cuda_fps.BLOCK_STATIC_SMEM) // 4
    assert largest == 57984 > _cuda.SMEM_LIMIT // 16      # more than the 16-byte layout took
    assert cuda_fps.fps_plan(largest, 1).per_lane == 0
    with pytest.raises(ValueError):
        cuda_fps.fps_plan(largest + 1, 1)
    for p, s in [(8, 0), (8, 9), (0, 0)]:
        with pytest.raises(ValueError):
            cuda_fps.fps_plan(p, s)


# ------------------------------------------------- FPS kernel arithmetic


def _dist(x, y, z, lx, ly, lz):
    """float32 ops rounded one by one, as the kernel's _rn intrinsics."""
    dx, dy, dz = x - lx, y - ly, z - lz
    return (dx * dx + dy * dy) + dz * dz


def _fps_warp_emulated(pts, s, per_lane):
    """csrc/fps.cu fps_warp_kernel for one cloud: lane l holds points
    l + 32 k (points past P copy point 0), a lane's tree argmax over k, then
    the max of the distances' bits and the min index among its holders."""
    p = pts.shape[0]
    j = np.arange(32)[:, None] + 32 * np.arange(per_lane)[None, :]      # [lane, k]
    src = np.where(j < p, j, 0)
    x, y, z = pts[src, 0], pts[src, 1], pts[src, 2]
    md = np.full(j.shape, np.inf, np.float32)
    out, last = [0], 0
    for _ in range(1, s):
        md = np.minimum(md, _dist(x, y, z, *pts[last]))
        v, at = md.copy(), np.tile(np.arange(per_lane), (32, 1))
        step = 1
        while step < per_lane:
            for k in range(0, per_lane - step, 2 * step):
                take = v[:, k + step] > v[:, k]
                v[:, k] = np.where(take, v[:, k + step], v[:, k])
                at[:, k] = np.where(take, at[:, k + step], at[:, k])
            step *= 2
        bits = v[:, 0].view(np.uint32)
        cand = np.where(bits == bits.max(), np.arange(32) + 32 * at[:, 0], 2 ** 32 - 1)
        last = int(cand.min())
        out.append(last)
    return np.array(out, np.int32)


def _fps_block_emulated(pts, s):
    """csrc/fps.cu fps_block_kernel for one cloud: thread t holds points
    t, t + T, ...; its first maximum, then the warps' and the block's
    (max bits, min index) over the winners."""
    p = pts.shape[0]
    threads = min(1024, (p + 31) // 32 * 32)
    md = np.full(p, np.inf, np.float32)
    out, last = [0], 0
    for _ in range(1, s):
        md = np.minimum(md, _dist(pts[:, 0], pts[:, 1], pts[:, 2], *pts[last]))
        best = np.full(threads, -1.0, np.float32)
        besti = np.full(threads, 2 ** 31 - 1, np.int64)
        for j in range(p):
            t = j % threads
            if md[j] > best[t]:
                best[t], besti[t] = md[j], j
        bits = np.maximum(best, 0).view(np.uint32).reshape(-1, 32)
        top = bits.max(axis=1)
        win = np.where(bits == top[:, None], besti.reshape(-1, 32), 2 ** 32 - 1).min(axis=1)
        last = int(win[top == top.max()].min())
        out.append(last)
    return np.array(out, np.int32)


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "grid"])
@pytest.mark.parametrize("p", [1, 5, 31, 32, 33, 70, 257])
def test_fps_warp_variant_arithmetic_is_the_plain_versions(kind, p):
    rng = np.random.default_rng(p)
    pts = _clouds(rng, 2, p, kind)
    s = min(p, 40)
    want, _ = farthest_point_sampling_plain(torch.from_numpy(pts), s)
    per_lane = cuda_fps.fps_plan(p, s).per_lane
    for i in range(2):
        np.testing.assert_array_equal(_fps_warp_emulated(pts[i], s, per_lane), want[i].numpy())


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "grid"])
def test_fps_block_variant_arithmetic_is_the_plain_versions(kind):
    rng = np.random.default_rng(7)
    pts = _clouds(rng, 1, 1100, kind)           # 1024 threads, two points on some
    want, _ = farthest_point_sampling_plain(torch.from_numpy(pts), 12)
    np.testing.assert_array_equal(_fps_block_emulated(pts[0], 12), want[0].numpy())


@pytest.mark.parametrize("kind", ["ties", "equal", "grid"])
def test_fps_plain_bit_equal_to_pallas_kernel_on_ties(kind):
    rng = np.random.default_rng(3)
    pts = _clouds(rng, 8, 64, kind)
    idx_j, xyz_j = farthest_point_sampling_pallas(
        jnp.asarray(pts), 64, tile_n=8, interpret=True, with_coords=True)
    idx_t, xyz_t = farthest_point_sampling_plain(torch.from_numpy(pts), 64)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(xyz_t.numpy(), np.asarray(xyz_j))


# ------------------------------------------------------------ gather plan


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("n,shape", [(64 * 28, s) for s in GALLERY]
                         + [(32 * 28, s) for s in PROBE])
def test_gather_plan_at_the_paths_shapes(es, n, shape):
    p, q, c = shape
    rb = c * es
    plan = cuda_gather.gather_plan(n, p, q, rb)
    assert plan.chunk_bytes > 0, "the paths' clouds are staged"
    assert rb % plan.word == 0 and plan.word == max(w for w in (2, 4, 8, 16) if rb % w == 0)
    assert plan.chunk_bytes % 16 == 0
    assert cuda_gather.MIN_CHUNK <= plan.chunk_bytes <= cuda_gather.MAX_CHUNK
    assert plan.chunks == -(-q * rb // plan.chunk_bytes)
    assert n * plan.chunks >= cuda_gather.BLOCKS_PER_SM * 132
    assert plan.smem == cuda_gather.staged_smem(p, rb, plan.chunk_bytes) <= _cuda.SMEM_LIMIT
    # The rows a chunk touches, plus the one past, fit its offsets (a cloud's
    # start repeats its place in a 16-byte word within 16 clouds).
    cb, slots, worst = plan.chunk_bytes, (plan.chunk_bytes + 16) // rb + 3, 0
    for cloud in range(16):
        a = cloud * q * rb
        a16 = _align16(a)
        for c in range(plan.chunks):
            lo = a if c == 0 else a16 + c * cb
            hi = min(a + q * rb, a16 + (c + 1) * cb)
            if lo < hi:
                worst = max(worst, (hi - 1 - a) // rb - (lo - a) // rb + 2)
    assert 0 < worst <= slots


def test_gather_plan_word_follows_the_alignment():
    assert cuda_gather.gather_plan(4, 8, 16, 64, align=16).word == 16
    assert cuda_gather.gather_plan(4, 8, 16, 64, align=4).word == 4
    assert cuda_gather.gather_plan(4, 8, 16, 134, align=16).word == 2
    with pytest.raises(ValueError):
        cuda_gather.gather_plan(4, 8, 16, 64, align=1)
    with pytest.raises(ValueError):
        cuda_gather.gather_plan(4, 8, 16, 3)


def test_gather_plan_splits_few_clouds_and_goes_direct_beyond_shared_memory():
    few = cuda_gather.gather_plan(2, 64, 4096, 256)
    assert few.chunk_bytes == cuda_gather.MIN_CHUNK and few.chunks == 256
    big = 4096 * 64 * 4                                  # a 1 MB cloud
    assert cuda_gather.gather_plan(1, 4096, 100, 256) == cuda_gather.GatherPlan(16, 0, 0, 0)
    assert big > _cuda.SMEM_LIMIT
    # The largest cloud that still stages, with the least chunk.
    p = (_cuda.SMEM_LIMIT - cuda_gather.staged_smem(0, 256, cuda_gather.MIN_CHUNK)) // 256
    plan = cuda_gather.gather_plan(1000, p, 4 * p, 256)
    assert plan.chunk_bytes == cuda_gather.MIN_CHUNK and plan.smem <= _cuda.SMEM_LIMIT
    assert cuda_gather.gather_plan(1000, p + 1, 4 * p, 256).chunk_bytes == 0


# ------------------------------------------------- gather kernel arithmetic


def _align16(x):
    return (x + 15) // 16 * 16


def _emulate(values, idx, plan, shift=0):
    """csrc/gather_rows.cu gather_staged_kernel over every block and thread,
    on bytes: values [N, P, rb] (each cloud `shift` bytes past a 16-byte
    boundary), idx [N, Q]; returns the output [N, Q, rb] and how often each
    byte was written."""
    n, p, rb = values.shape
    q = idx.shape[1]
    w, cb, chunks, threads = plan.word, plan.chunk_bytes, plan.chunks, cuda_gather.THREADS
    out = np.zeros(n * q * rb, np.uint8)
    writes = np.zeros(n * q * rb, np.int32)
    zero_off = _align16(p * rb) + 16
    slots = (cb + 16) // rb + 3
    for blk in range(n * chunks):
        cloud, c = divmod(blk, chunks)
        a = cloud * q * rb
        b = a + q * rb
        a16 = _align16(a)
        lo = a if c == 0 else a16 + c * cb
        hi = min(b, a16 + (c + 1) * cb)
        if lo >= hi:
            continue
        r0, r1 = (lo - a) // rb, (hi - 1 - a) // rb
        assert r1 - r0 + 2 <= slots
        smem = np.zeros(zero_off + _align16(rb), np.uint8)
        smem[shift:shift + p * rb] = values[cloud].reshape(-1)
        base = []
        for r in range(r1 - r0 + 2):
            row = r0 + r
            j = idx[cloud, row] if row < q else -1
            base.append(shift + j * rb if 0 <= j < p else zero_off)

        def put(o, data):
            assert lo <= o and o + len(data) <= hi and o % len(data) == 0
            out[o:o + len(data)] = data
            writes[o:o + len(data)] += 1

        m0, m1 = _align16(lo), hi // 16 * 16
        nseg = (m1 - m0) // 16 if m1 > m0 else 0
        dr, dc = divmod(16 * (threads - 1), rb)
        for t in range(min(threads, nseg)):
            off = m0 + 16 * t - a
            r, col = divmod(off, rb)
            r -= r0
            for sg in range(t, nseg, threads):
                bs, seg = base[r], []
                for _ in range(16 // w):
                    assert (bs + col) % w == 0
                    seg.append(smem[bs + col:bs + col + w])
                    col += w
                    if col == rb:
                        col, r = 0, r + 1
                        bs = base[r]
                put(m0 + 16 * sg, np.concatenate(seg))
                col, r = col + dc, r + dr
                if col >= rb:
                    col, r = col - rb, r + 1
        h1 = min(m0, hi)
        t0 = max(m1, h1)
        nh, nt = (h1 - lo) // w, (hi - t0) // w
        for k in range(nh + nt):
            o = lo + k * w if k < nh else t0 + (k - nh) * w
            r, col = divmod(o - a, rb)
            put(o, smem[base[r - r0] + col:base[r - r0] + col + w])
    return out.reshape(n, q, rb), writes


@pytest.mark.parametrize("es,c", [(2, 1), (2, 3), (2, 6), (2, 67), (4, 1), (4, 6), (4, 67),
                                  (4, 32)])
@pytest.mark.parametrize("rows", ["one", "few", "chunks"])
def test_gather_staged_arithmetic_writes_every_byte_once(es, c, rows):
    rb = c * es
    q = {"one": 1, "few": 7, "chunks": 12000 // rb + 5}[rows]   # chunks: 3+ blocks a cloud
    rng = np.random.default_rng(q * 131 + c)
    n, p = 3, 21
    values = rng.integers(0, 256, (n, p, rb), dtype=np.uint8)
    idx = rng.integers(-2, p + 2, (n, q)).astype(np.int32)     # -2, -1, P, P+1: zero rows
    idx[0, 0], idx[-1, -1] = -1, p
    want = values[np.arange(n)[:, None], np.clip(idx, 0, p - 1)]
    want[(idx < 0) | (idx >= p)] = 0
    for shift in (0, es, 8):                     # the values' address past 16 bytes
        plan = cuda_gather.gather_plan(n, p, q, rb, align=16 if shift == 0 else shift & -shift)
        assert plan.word <= (16 if shift == 0 else shift & -shift)
        # The least chunk too, so that a cloud spans several blocks.
        small = cuda_gather.GatherPlan(plan.word, cuda_gather.MIN_CHUNK,
                                       -(-q * rb // cuda_gather.MIN_CHUNK), plan.smem)
        for pl in {plan, small}:
            got, writes = _emulate(values, idx, pl, shift)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, want)


def test_gather_cpu_dispatch_is_the_plain_version():
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.normal(size=(4, 9, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (4, 13)).astype(np.int32))
    assert torch.equal(gather_rows(values, idx), gather_rows_plain(values, idx))
