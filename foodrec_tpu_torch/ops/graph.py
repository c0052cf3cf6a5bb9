# coding: utf-8
"""Host-side graph preprocessing: one-time normalized-adjacency builds.

A copy of the builders of `foodrec_tpu/ops/graph.py` that serving uses, so
rows, cols and vals come out bit-identical (f64 degrees, then f32 values),
plus the CSR row pointer the CUDA SpMM reads.

Normalization semantics (reference cikm_model.py:166-172): symmetric,
d = binary_degree + 1e-7 ; val(r,c) = d[r]^-1/2 * d[c]^-1/2 over the
deduplicated symmetrized edge set.
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
    vals: np.ndarray     # float32 [nnz]
    row_ptr: np.ndarray  # int32 [n_nodes + 1]: row r is [row_ptr[r], row_ptr[r+1])
    # ELL: one padded neighbour table; pad col = 0 with val = 0. None for
    # graphs with a row above ELL_DEGREE_CAP.
    ell_cols: np.ndarray  # int32 [n_nodes, max_deg] or None
    ell_vals: np.ndarray  # float32 [n_nodes, max_deg] or None
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


def _build(rows, cols, vals, n_nodes, symmetric=False):
    vals = vals.astype(np.float32)
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
