"""DBSCAN on the device, label for label with
`sklearn.cluster.DBSCAN(eps, min_samples=5)` (euclidean), many clouds at
once. It stands in for the scikit-learn call of
text2loc_tpu/prep/cells.py:66 _cluster_stuff; the port needs no
scikit-learn.

scikit-learn's rules, which this reproduces:

* neighbours of a point: every point (itself included) whose squared
  distance (dx*dx + dy*dy) + dz*dz is at most eps*eps (its KD-tree compares
  reduced distances, `<=`);
* a point is core when it has at least min_samples neighbours;
* core points joined by neighbour edges form one cluster; clusters are
  numbered in the order of their lowest core index;
* a non-core point with a core neighbour takes the smallest cluster id among
  its core neighbours (the first cluster whose depth-first walk reaches
  it); every other point is noise, -1.

Design: a grid hash at cell size just above eps over (cloud, cell x, y, z)
keys, so a point's neighbours lie in the 27 cells around its own; a sorted
key array gives each cell's point range; the candidate pairs are expanded
in chunks of at most `max_pairs`, filtered by distance into an edge list;
components by min-label propagation over core-core edges with pointer
jumping; cluster ids by rank of each component's lowest index within its
cloud.
"""

from __future__ import annotations

import itertools

import torch

from text2loc_tpu_torch.prep.exact import div, sumsq3

# The hash cell is this much wider than eps, so no rounding of x / cell puts
# two points within eps more than one cell apart.
_CELL_MARGIN = 1.0 + 2.0 ** -20


def dbscan(xyz: torch.Tensor, cloud: torch.Tensor, eps: float = 0.75,
           min_samples: int = 5, max_pairs: int = 1 << 23) -> torch.Tensor:
    """Cluster labels [M] (int64, -1 noise) of xyz [M, 3] (float64), each
    cloud clustered on its own; cloud [M] (int64) are the points' cloud ids,
    nondecreasing. Labels count from 0 in every cloud."""
    m = len(xyz)
    dev = xyz.device
    labels = torch.full((m,), -1, dtype=torch.int64, device=dev)
    if m == 0:
        return labels
    if not bool((cloud[1:] >= cloud[:-1]).all()):
        raise ValueError("dbscan: cloud ids must be nondecreasing")

    # Hash keys: cells relative to each cloud's lowest cell, shifted by one so
    # a neighbour offset of -1 stays inside the cloud's key range.
    cell = torch.floor(div(xyz, eps * _CELL_MARGIN)).to(torch.int64)
    n_clouds = int(cloud[-1]) + 1
    lowest = torch.full((n_clouds, 3), torch.iinfo(torch.int64).max, dtype=torch.int64,
                        device=dev)
    lowest = lowest.scatter_reduce(0, cloud[:, None].expand(m, 3), cell, "amin")
    rel = cell - lowest[cloud] + 1
    s0, s1, s2 = (int(v) + 2 for v in rel.amax(0).tolist())
    if n_clouds * s0 * s1 * s2 >= 2 ** 62:
        raise ValueError("dbscan: the clouds span too many cells for int64 keys")
    key = ((cloud * s0 + rel[:, 0]) * s1 + rel[:, 1]) * s2 + rel[:, 2]

    order = torch.argsort(key, stable=True)
    sxyz = xyz[order]
    ukey, counts = torch.unique_consecutive(key[order], return_counts=True)
    ustart = torch.cumsum(counts, 0) - counts
    cell_of = torch.repeat_interleave(torch.arange(len(ukey), device=dev), counts)
    deltas = torch.tensor([(dx * s1 + dy) * s2 + dz
                           for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3)],
                          device=dev)
    near = ukey[:, None] + deltas
    pos = torch.searchsorted(ukey, near).clamp_(max=len(ukey) - 1)
    hit = ukey[pos] == near
    nstart = torch.where(hit, ustart[pos], 0)            # [cells, 27]
    ncount = torch.where(hit, counts[pos], 0)

    # Candidate pairs, in chunks of sorted points of at most max_pairs.
    cum = torch.cumsum(ncount.sum(1)[cell_of], 0)
    marks = torch.arange(max_pairs, int(cum[-1]) + max_pairs, max_pairs, device=dev)
    bounds = [0] + torch.searchsorted(cum, marks, right=True).tolist()
    eps2 = float(eps) * float(eps)
    ei, ej = [], []
    for p0, p1 in zip(bounds[:-1], bounds[1:]):
        if p1 <= p0:
            continue
        lens = ncount[cell_of[p0:p1]].reshape(-1)
        starts = nstart[cell_of[p0:p1]].reshape(-1)
        seg = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
        first = torch.cumsum(lens, 0) - lens
        j = starts[seg] + (torch.arange(len(seg), device=dev) - first[seg])
        i = p0 + torch.div(seg, 27, rounding_mode="floor")
        within = sumsq3(sxyz[i] - sxyz[j]) <= eps2
        ei.append(order[i[within]])
        ej.append(order[j[within]])
    ei, ej = torch.cat(ei), torch.cat(ej)

    core = torch.bincount(ei, minlength=m) >= min_samples
    both = core[ei] & core[ej]
    a, b = ei[both], ej[both]
    lab = torch.arange(m, device=dev)
    while True:
        new = lab.scatter_reduce(0, a, lab[b], "amin")
        new = new[new]
        if torch.equal(new, lab):
            break
        lab = new

    roots = torch.nonzero(core & (lab == torch.arange(m, device=dev)))[:, 0]
    root_cloud = cloud[roots]
    cluster_of_root = torch.full((m,), -1, dtype=torch.int64, device=dev)
    cluster_of_root[roots] = (torch.arange(len(roots), device=dev)
                              - torch.searchsorted(root_cloud, root_cloud))
    labels[core] = cluster_of_root[lab[core]]
    border = ~core[ei] & core[ej]
    best = torch.full((m,), m, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, ei[border], labels[ej[border]], "amin")
    take = ~core & (best < m)
    labels[take] = best[take]
    return labels
