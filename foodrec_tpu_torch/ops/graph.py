# coding: utf-8
"""Host-side graph preprocessing: one-time normalized-adjacency builds.

A copy of the builders of `foodrec_tpu/ops/graph.py` that the ported models
use, so rows, cols and vals come out bit-identical, plus the CSR row pointer
the CUDA SpMM reads, and `transpose_adjacency` for the SpMM backward of a
graph that is not symmetric. Both normalizations run over the deduplicated
symmetrized edge set:

  * symmetric (reference cikm_model.py:166-172 and clones):
    d = binary_degree + 1e-7 ; val(r,c) = d[r]^-1/2 * d[c]^-1/2, f64 degrees
    then f32 values
  * row (FGCN, reference fgcn.py:84-106): val(r,c) = 1 / deg[r], the
    reciprocal taken in f32; not symmetric

and one over a directed edge list, without symmetrizing:

  * GCNConv (SCHGN, reference schgn.py:29-41): self loops added, deg = the
    in-degree + 1, val(s,d) = deg[s]^-1/2 * deg[d]^-1/2 with rows = dst;
    the values stay f64 (the Propagator rounds them once to f32 on the card)
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NormalizedAdjacency:
    """A normalized sparse adjacency over `n_nodes`, stored as row-sorted COO
    with its CSR row pointer, and as ELL for bounded-degree graphs."""

    n_nodes: int
    rows: np.ndarray     # int32 [nnz], sorted (row-major)
    cols: np.ndarray     # int32 [nnz]
    vals: np.ndarray     # float32 [nnz] (float64 from gcn_conv_adjacency)
    row_ptr: np.ndarray  # int32 [n_nodes + 1]: row r is [row_ptr[r], row_ptr[r+1])
    # ELL: one padded neighbour table; pad col = 0 with val = 0. None for
    # graphs with a row above ELL_DEGREE_CAP.
    ell_cols: np.ndarray  # int32 [n_nodes, max_deg] or None
    ell_vals: np.ndarray  # vals' dtype [n_nodes, max_deg] or None
    max_degree: int
    symmetric: bool = False

    @property
    def nnz(self):
        return len(self.rows)

    @property
    def has_ell(self):
        return self.ell_cols is not None


def _dedup_symmetrize(rows, cols, n_nodes):
    """Unique undirected edge set as both directions (matches the dok-dict
    dedup in the reference adjacency builders)."""
    r = np.concatenate([rows, cols]).astype(np.int64)
    c = np.concatenate([cols, rows]).astype(np.int64)
    key = r * n_nodes + c
    key = np.unique(key)
    return (key // n_nodes).astype(np.int64), (key % n_nodes).astype(np.int64)


def _to_sorted_coo(rows, cols, vals):
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def _to_ell(rows, cols, vals, n_nodes):
    counts = np.bincount(rows, minlength=n_nodes)
    md = max(int(counts.max()), 1)
    ell_cols = np.zeros((n_nodes, md), dtype=np.int32)
    ell_vals = np.zeros((n_nodes, md), dtype=vals.dtype)
    # rows is sorted; slot index = position within its row run
    slot = np.arange(len(rows)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    ell_cols[rows, slot] = cols
    ell_vals[rows, slot] = vals
    return ell_cols, ell_vals, md


ELL_DEGREE_CAP = 96  # above this, the padded table wastes memory on power-law rows


def _build(rows, cols, vals, n_nodes, symmetric=False, vals_dtype=np.float32):
    """vals_dtype=None keeps the values' own dtype (see transpose_adjacency)."""
    if vals_dtype is not None:
        vals = vals.astype(vals_dtype)
    rows, cols, vals = _to_sorted_coo(
        rows.astype(np.int64), cols.astype(np.int64), vals)
    counts = np.bincount(rows, minlength=n_nodes)
    md = int(counts.max()) if len(rows) else 1
    if md <= ELL_DEGREE_CAP:
        ell_cols, ell_vals, md = _to_ell(rows, cols, vals, n_nodes)
    else:
        ell_cols, ell_vals = None, None
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return NormalizedAdjacency(
        n_nodes=n_nodes,
        rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals,
        row_ptr=row_ptr,
        ell_cols=ell_cols, ell_vals=ell_vals, max_degree=md,
        symmetric=symmetric)


def sym_normalized_adjacency(rows, cols, n_nodes):
    """D^-1/2 A D^-1/2 with +1e-7 on the binary degree over the symmetrized
    edge set (reference: cikm_model.py:136-180 and clones)."""
    rows, cols = _dedup_symmetrize(np.asarray(rows), np.asarray(cols), n_nodes)
    deg = np.bincount(rows, minlength=n_nodes).astype(np.float64)
    d = np.power(deg + 1e-7, -0.5)
    vals = d[rows] * d[cols]
    # symmetrized edge set + symmetric values -> A == A^T
    return _build(rows, cols, vals, n_nodes, symmetric=True)


def row_normalized_adjacency(rows, cols, n_nodes):
    """D^-1 A (reference: fgcn.py:84-106). The reciprocal is taken in f32,
    as the reference takes np.power(rowsum_f32, -1) of a float32 dok matrix:
    f64-then-cast rounds differently on ~1 ulp of rows. An isolated node's
    row stays empty (its inf reciprocal is set to 0)."""
    rows, cols = _dedup_symmetrize(np.asarray(rows), np.asarray(cols), n_nodes)
    deg = np.bincount(rows, minlength=n_nodes).astype(np.float32)
    with np.errstate(divide="ignore"):
        d_inv = np.power(deg, np.float32(-1.0))
    d_inv[np.isinf(d_inv)] = 0.0
    return _build(rows, cols, d_inv[rows], n_nodes)


def gcn_conv_adjacency(src, dst, n_nodes):
    """torch_geometric GCNConv's gcn_norm over a directed edge list (SCHGN's
    heterogeneous graph): A_hat = A + I, deg[i] = in-degree(i) + 1 clamped
    at 1e-12, val(s, d) = deg[s]^-1/2 * deg[d]^-1/2, y[d] = sum val * x[s].
    The degree is taken on the target column and indexed at both ends of an
    edge, as PyG does. Rows are the targets; the values stay float64."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    loop = np.arange(n_nodes, dtype=np.int64)
    src = np.concatenate([src, loop])
    dst = np.concatenate([dst, loop])
    deg = np.bincount(dst, minlength=n_nodes).astype(np.float64)
    d_inv_sqrt = np.power(np.maximum(deg, 1e-12), -0.5)
    return _build(dst, src, d_inv_sqrt[src] * d_inv_sqrt[dst], n_nodes,
                  vals_dtype=None)


def transpose_adjacency(adj):
    """A^T as its own row-sorted NormalizedAdjacency (the SpMM backward of a
    graph that is not symmetric; a symmetric one is its own transpose)."""
    if adj.symmetric:
        return adj
    # vals_dtype=None: vals already carry their final dtype -- re-casting to
    # f32 here would round only the BACKWARD adjacency of an f64 graph
    return _build(adj.cols, adj.rows, adj.vals, adj.n_nodes, vals_dtype=None)


def bipartite_offset_edges(triples, offset_head=0, offset_tail=0):
    """Map (head, tail) triples into a joint node-id space; returns (rows,
    cols) of the directed tail->head edges before symmetrize
    (cikm_model.py:91-106)."""
    triples = np.asarray(triples, dtype=np.int64)
    heads = triples[:, 0] + offset_head
    tails = triples[:, 1] + offset_tail
    return tails, heads


def ui_bipartite_edges(train_coo, n_users):
    """(user, item+n_users) directed edges from the train COO
    (cikm_model.py:149-165)."""
    rows = np.asarray(train_coo.row, dtype=np.int64)
    cols = np.asarray(train_coo.col, dtype=np.int64) + n_users
    return rows, cols
