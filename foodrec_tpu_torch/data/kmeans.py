# coding: utf-8
"""Mini-batch k-means on the device: the algorithm of scikit-learn's
`MiniBatchKMeans` (sklearn/cluster/_kmeans.py, 1.9), which the JAX
package's pipeline calls (`foodrec_tpu/data/preprocess.py:
kmeans_cluster_edges`) and which the card's machine does not have.

What is reproduced is the algorithm, not scikit-learn's random stream:

  * init: k-means++ with 2 + log(k) local trials a centre, on a random
    subset of INIT_SIZE rows (3·k rows when INIT_SIZE < k, as sklearn sets
    it), N_INIT times; the init of least inertia on one validation subset
    of the same size is kept;
  * MAX_ITER · n // BATCH_SIZE steps, each on BATCH_SIZE rows drawn
    uniformly with replacement: every row to its nearest centre, and each
    centre that got rows moves to the count-weighted mean of its old
    position (weighted by all the rows it has had) and the new rows;
  * low-count centres moved onto random rows of the batch, when a centre
    has count 0 or after every 10·k rows seen: those under
    REASSIGNMENT_RATIO of the largest count, at most half a batch of them,
    their counts reset to the least count kept;
  * early stopping when the exponentially weighted mean of the batch
    inertia has not improved for MAX_NO_IMPROVEMENT steps.

Every array lives on `device`, and the draws come from a `torch.Generator`
on it seeded by `seed`. The final inertia is over all rows, as
`MiniBatchKMeans.inertia_` is with `compute_labels=True`.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device

CHUNK_ROWS = 8192   # rows of x against all centres at once
# the JAX package's MiniBatchKMeans(init_size=512, batch_size=1024,
# n_init=3) and scikit-learn's defaults for the rest
BATCH_SIZE = 1024
INIT_SIZE = 512
N_INIT = 3
MAX_ITER = 100
MAX_NO_IMPROVEMENT = 10
REASSIGNMENT_RATIO = 0.01


@dataclass
class KMeansResult:
    centers: np.ndarray     # [k, d] in the input's dtype
    inertia: float          # sum over all rows of the squared distance
    init_inertia: float     # the same for the kept k-means++ init
    n_steps: int            # mini-batch steps run (early stopping)


def _sq_dist(a, b, b_sq):
    """[len(a), len(b)] squared distances, ‖a‖² − 2a·bᵀ + ‖b‖², >= 0."""
    d = (a * a).sum(1, keepdim=True) - 2 * (a @ b.T) + b_sq[None, :]
    return d.clamp_min_(0)


def labels_inertia(x, centers):
    """Nearest centre of every row and the sum of the squared distances, in
    blocks of CHUNK_ROWS rows. The inertia stays on the device (a 0-d
    tensor)."""
    c_sq = (centers * centers).sum(1)
    labels, inertia = [], x.new_zeros((), dtype=torch.float64)
    for s in range(0, len(x), CHUNK_ROWS):
        d, lab = _sq_dist(x[s:s + CHUNK_ROWS], centers, c_sq).min(1)
        labels.append(lab)
        inertia = inertia + d.sum(dtype=torch.float64)
    return torch.cat(labels), inertia


def kmeans_plusplus(x, n_clusters, generator):
    """k-means++ seeding (sklearn's `_kmeans_plusplus`, unit weights): the
    first centre uniform, then each next the best of 2 + log(k) candidates
    drawn with probability proportional to the squared distance to the
    nearest centre so far. Distances in float64, as sklearn computes them
    for float32 data. Nothing waits for the host."""
    n = len(x)
    n_local_trials = 2 + int(math.log(n_clusters))
    x64 = x.double()
    x_sq = (x64 * x64).sum(1)
    idx = torch.empty(n_clusters, dtype=torch.long, device=x.device)
    idx[0] = torch.randint(n, (1,), generator=generator, device=x.device)[0]
    closest = _sq_dist(x64[idx[:1]], x64, x_sq)[0]
    pot = closest.sum()
    for c in range(1, n_clusters):
        r = torch.rand(n_local_trials, generator=generator, device=x.device,
                       dtype=torch.float64) * pot
        cand = torch.searchsorted(torch.cumsum(closest, 0), r)
        cand.clamp_(max=n - 1)
        d = torch.minimum(closest[None, :], _sq_dist(x64[cand], x64, x_sq))
        pots = d.sum(1)
        best = torch.argmin(pots)
        pot = pots[best]
        closest = d[best]
        idx[c] = cand[best]
    return x[idx]


def minibatch_kmeans(features, n_clusters, seed=0, device="cuda"):
    """Fit `n_clusters` centres to the rows of `features` ([n, d] float32 or
    float64, numpy or torch) on `device`. Returns a KMeansResult whose
    centres are a numpy array of the input's dtype."""
    device = resolve_device(device)
    x = torch.as_tensor(np.ascontiguousarray(features)
                        if isinstance(features, np.ndarray) else features)
    x = x.to(device)
    n = len(x)
    if not 0 < n_clusters <= n:
        raise ValueError(f"n_clusters={n_clusters} for {n} rows")
    g = torch.Generator(device=device).manual_seed(seed)
    batch = min(BATCH_SIZE, n)
    n_sub = INIT_SIZE
    if n_sub < n_clusters:
        n_sub = 3 * n_clusters
    n_sub = min(n_sub, n)

    # inits on random subsets, the best on one validation subset
    valid = x[torch.randint(n, (n_sub,), generator=g, device=device)]
    best, best_inertia = None, None
    for _ in range(N_INIT):
        sub = (x[torch.randint(n, (n_sub,), generator=g, device=device)]
               if n_sub < n else x)
        centers = kmeans_plusplus(sub, n_clusters, g)
        inertia = float(labels_inertia(valid, centers)[1])
        if best is None or inertia < best_inertia:
            best, best_inertia = centers, inertia
    centers = best
    init_inertia = float(labels_inertia(x, centers)[1])

    counts = torch.zeros(n_clusters, dtype=x.dtype, device=device)
    since_reassign = 0
    ewa = ewa_min = None
    no_improvement = 0
    n_steps = MAX_ITER * n // batch
    step = 0
    for step in range(n_steps):
        xb = x[torch.randint(n, (batch,), generator=g, device=device)]
        # sklearn's _random_reassign, read before the step's update
        since_reassign += batch
        reassign = False
        if bool((counts == 0).any()) or since_reassign >= 10 * n_clusters:
            since_reassign, reassign = 0, True

        labels, batch_inertia = labels_inertia(xb, centers)
        wsum = torch.bincount(labels, minlength=n_clusters).to(x.dtype)
        sums = torch.zeros_like(centers).index_add_(0, labels, xb)
        new_counts = counts + wsum
        moved = ((centers * counts[:, None] + sums)
                 / new_counts.clamp_min(1)[:, None])
        centers = torch.where((wsum > 0)[:, None], moved, centers)
        counts = new_counts
        if reassign:
            low = counts < REASSIGNMENT_RATIO * counts.max()
            if int(low.sum()) > 0.5 * batch:
                keep = torch.argsort(counts, stable=True)[int(0.5 * batch):]
                low[keep] = False
            n_low = int(low.sum())
            if n_low:
                pick = torch.randperm(batch, generator=g, device=device)
                centers[low] = xb[pick[:n_low]]
            counts[low] = counts[~low].min()

        # sklearn's _mini_batch_convergence (tol 0): the first step's
        # inertia is the init's and is not read
        if step == 0:
            continue
        b = float(batch_inertia) / batch
        if ewa is None:
            ewa = b
        else:
            alpha = min(batch * 2.0 / (n + 1), 1)
            ewa = ewa * (1 - alpha) + b * alpha
        if ewa_min is None or ewa < ewa_min:
            no_improvement, ewa_min = 0, ewa
        else:
            no_improvement += 1
        if no_improvement >= MAX_NO_IMPROVEMENT:
            break
    inertia = float(labels_inertia(x, centers)[1])
    return KMeansResult(centers=centers.cpu().numpy(), inertia=inertia,
                        init_inertia=init_inertia, n_steps=step + 1)


def nearest_centers(features, centers, k, device="cuda", chunk=2048):
    """[n, k] indices of each row's k nearest centres, nearest first: the
    blocked ‖x‖² − 2x·Cᵀ + ‖C‖² of the JAX package's edge step, then
    `torch.topk(k, largest=False, sorted=True)`. In the dtype of
    `features`."""
    device = resolve_device(device)
    x = torch.as_tensor(np.ascontiguousarray(features)).to(device)
    c = torch.as_tensor(np.ascontiguousarray(centers)).to(device, x.dtype)
    c_norm = (c ** 2).sum(1)
    k = min(k, len(c))
    out = []
    for s in range(0, len(x), chunk):
        xb = x[s:s + chunk]
        d2 = (xb ** 2).sum(1, keepdim=True) - 2 * xb @ c.T + c_norm[None, :]
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True)[1])
    if not out:
        return np.zeros((0, k), dtype=np.int64)
    return torch.cat(out).cpu().numpy()
