"""FLOPs of one SCHGN training step, from the shapes: the matrix products
and the SpMM product of the forward, with each product's backward (two
products of the same size for a matrix product whose two inputs train, one
for the image projection, whose input table is fixed, and one for the
SpMM, the product with A^T, whose graph does not train). Elementwise work,
softmax, gathers and the optimizer are not counted."""

import os

import numpy as np

from portbench.reference import plain


def _edges(base, name):
    return len(np.loadtxt(os.path.join(base, "graph_edge", name),
                          delimiter="\t", dtype=np.int64, ndmin=2))


def graphs(data):
    """{nodes: edges} of A_hat = A + I over users, items, ingredients and
    calorie levels: the directed edges item -> user, ingredient -> item and
    calorie level -> item, and a self loop at every node. A^T, the
    backward's graph, has the same nodes and edges."""
    base = os.path.dirname(data["img_path"])
    rc = np.loadtxt(os.path.join(base, "graph_edge", "rc_graph.txt"),
                    delimiter="\t", dtype=np.int64, ndmin=2)
    n = (data["n_users"] + data["n_items"] + data["n_ingredients"]
         + int(rc[:, 1].max()) + 1)
    return {n: _edges(base, "ur_graph.txt") + _edges(base, "ri_graph.txt")
            + len(rc) + n}


def step_flops(shapes, graphs, batch, mc):
    d, h = mc["embedding_size"], mc["num_attention_heads"]
    inner = mc["inner_size"]
    L = plain.MAX_INGRE_LEN
    dh = d // h
    (n, nnz), = graphs.items()
    gcn = 2 * n * d * d
    b2 = 2 * batch  # the positives' and the negatives' scores
    ingredient = 2 * b2 * L * 3 * d * d + 2 * 2 * b2 * L * d
    component = 2 * 4 * b2 * 2 * d * d + 2 * 4 * b2 * d + 2 * b2 * 4 * d
    scorer = 2 * b2 * 3 * d * d + 2 * b2 * d
    t = batch * L  # the SSL's tokens: the positives' sequences
    encoder = mc["num_hidden_layers"] * (
        4 * 2 * t * d * d               # q, k, v, dense
        + 2 * 2 * batch * h * L * L * dh  # logits, attention @ v
        + 2 * 2 * t * d * inner)        # feed-forward
    ssl = encoder + 2 * t * d * d + 2 * 2 * t * d
    image = 2 * b2 * shapes["img_dim"] * d
    return (3 * (gcn + ingredient + component + scorer + ssl) + 2 * image
            + 2 * 2 * d * nnz)
