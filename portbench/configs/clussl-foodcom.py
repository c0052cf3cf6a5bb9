"""FLOPs of one CLUSSL (PRICAI_ModelX) training step, from the shapes: the
SpMM products of the forward (n_ri_layers hops on each of the three item
views, n_ui_layers on the user-item graph) with each one's backward, the
product with A^T; the distance correlation's Gram products X X^T, two a
view pair, with their backward (two products of the same size: both
operands are X, which trains); and the BPR's dot products with theirs.
Elementwise work (the distance matrices' square roots and centering, the
layer means), gathers and the optimizer are not counted."""

import os

import numpy as np

from portbench.reference import plain

# the view pairs whose distance correlation the loss sums
DCOR_PAIRS = 3


def graphs(data):
    """{nodes: edges} of the symmetrized deduplicated graphs: user-item,
    item-ingredient, and the image and text cluster graphs. The two
    cluster graphs both have n_items + n_cluster nodes (n_cluster read as
    the largest cluster id + 1) and share one key, which holds the mean of
    their edge counts: each draws 2 clusters an item at random, so an
    item's two edges coincide with probability 1/n_cluster and are
    deduplicated: at the benchmark's Foodcom dataset 119,758 and 119,744
    of 119,772 directed pairs, 14 apart."""
    nu, ni, ning = data["n_users"], data["n_items"], data["n_ingredients"]
    ri = data["ri"]
    out = {nu + ni: plain.nnz(data["train_u"], data["train_i"] + nu, nu + ni),
           ni + ning: plain.nnz(ri[:, 1] + ni, ri[:, 0], ni + ning)}
    base = os.path.join(os.path.dirname(data["img_path"]), "cluster")
    edges = [np.loadtxt(os.path.join(base, f"{m}_cluster_edge.txt"),
                        dtype=np.int64, ndmin=2) for m in ("image", "text")]
    nc = max(int(e[:, 1].max()) for e in edges) + 1
    out[ni + nc] = int(round(np.mean(
        [plain.nnz(e[:, 1] + ni, e[:, 0], ni + nc) for e in edges])))
    return out


def step_flops(shapes, graphs, batch, mc):
    d = mc["embedding_size"]
    nu, ni = shapes["n_users"], shapes["n_items"]
    ri_hops = mc["n_ri_layers"]
    spmm = 2 * d * (
        ri_hops * graphs[ni + shapes["n_ingredients"]]
        + 2 * ri_hops * graphs[ni + int(mc["n_cluster"])]
        + mc["n_ui_layers"] * graphs[nu + ni])
    rows = 2 * batch  # the dCor's rows: the positives and the negatives
    gram = 2 * rows * rows * d
    dcor = 2 * DCOR_PAIRS * gram
    bpr = 2 * 2 * batch * d
    return 3 * (dcor + bpr) + 2 * spmm
