# coding: utf-8
"""LATTICE-style kNN-graph utilities (counterpart of
`foodrec_tpu/utils/graph_utils.py`; reference FoodRec/utils/utils.py:116-191).

No shipped model calls them; they are the reference's public utilities. An
edge list is (edge_index [2, E], edge_weight [E]), as the JAX package returns
it, where the reference returns a torch sparse tensor.
"""

import torch


def build_sim(context):
    """Row-normalized cosine similarity matrix (utils.py:133-136)."""
    context_norm = context / torch.linalg.vector_norm(context, dim=-1,
                                                      keepdim=True)
    return context_norm @ context_norm.T


def build_knn_neighbourhood(adj, topk):
    """Each row's top-k entries kept, zero elsewhere (utils.py:118-121)."""
    knn_val, knn_ind = torch.topk(adj, topk, dim=-1)
    return torch.zeros_like(adj).scatter_(-1, knn_ind, knn_val)


def _inv_pow(x, p):
    """x ** p where x > 0, else 0."""
    return torch.where(x > 0, x.clamp_min(torch.finfo(x.dtype).tiny) ** p,
                       torch.zeros_like(x))


def compute_normalized_laplacian(adj):
    """D^-1/2 A D^-1/2 of a dense adjacency (utils.py:124-130)."""
    d_inv_sqrt = _inv_pow(adj.sum(-1), -0.5)
    return adj * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


def get_sparse_laplacian(edge_index, edge_weight, num_nodes,
                         normalization="none"):
    """Normalized edge weights of an edge list (utils.py:138-151): `sym`
    d[row]^-1/2 w d[col]^-1/2, `rw` w / d[row], with d the weighted
    out-degree; `none` leaves them."""
    row, col = edge_index[0], edge_index[1]
    deg = edge_weight.new_zeros(num_nodes).index_add_(0, row, edge_weight)
    if normalization == "sym":
        d = _inv_pow(deg, -0.5)
        edge_weight = d[row] * edge_weight * d[col]
    elif normalization == "rw":
        d = _inv_pow(deg, -1.0)
        edge_weight = d[row] * edge_weight
    return edge_index, edge_weight


def get_dense_laplacian(adj, normalization="none"):
    """(utils.py:153-168)"""
    if normalization == "sym":
        return compute_normalized_laplacian(adj)
    if normalization == "rw":
        return adj * _inv_pow(adj.sum(-1), -1.0)[:, None]
    return adj


def build_knn_normalized_graph(adj, topk, is_sparse, norm_type):
    """The top-k sparsified, normalized graph (utils.py:170-183): an edge
    list if `is_sparse`, else a dense matrix."""
    if is_sparse:
        knn_val, knn_ind = torch.topk(adj, topk, dim=-1)
        n = adj.shape[0]
        row = torch.arange(n, device=adj.device).repeat_interleave(topk)
        edge_index = torch.stack([row, knn_ind.reshape(-1)])
        return get_sparse_laplacian(edge_index, knn_val.reshape(-1),
                                    num_nodes=n, normalization=norm_type)
    return get_dense_laplacian(build_knn_neighbourhood(adj, topk),
                               normalization=norm_type)
