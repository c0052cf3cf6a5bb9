# coding: utf-8
"""Vectorized top-k metric kernels, numerically identical to the reference
(FoodRec/common/matrics.py): cumulative-at-k numpy formulas over a boolean
hit matrix. A copy of `foodrec_tpu/engine/matrics.py`; they run on the host
after the device's top-k (engine/topk_evaluator.py, `full_sort_topk`).
"""

import numpy as np


def recall_(pos_index, pos_len):
    """Mean per-user recall at every cutoff (matrics.py:9-12)."""
    rec = np.cumsum(pos_index, axis=1) / pos_len.reshape(-1, 1)
    return rec.mean(axis=0)


def recall2_(pos_index, pos_len):
    """Sum-hits / sum-positives variant (matrics.py:15-24)."""
    rec_cum = np.cumsum(pos_index, axis=1)
    return rec_cum.sum(axis=0) / pos_len.sum()


def ndcg_(pos_index, pos_len):
    """Binary-relevance NDCG with per-row IDCG truncation (matrics.py:27-60)."""
    n, k = pos_index.shape
    idcg_len = np.minimum(pos_len, k)

    ranks = np.arange(1, k + 1, dtype=np.float32)
    gains = 1.0 / np.log2(ranks + 1)
    idcg_all = np.cumsum(gains)
    # idcg[row, j] = idcg at min(j+1, idcg_len[row]) — clamp via indexing
    col = np.broadcast_to(np.arange(k), (n, k))
    clamped = np.minimum(col, idcg_len.reshape(-1, 1) - 1)
    idcg = idcg_all[np.maximum(clamped, 0)]

    dcg = np.cumsum(np.where(pos_index, gains, 0.0), axis=1)
    return (dcg / idcg).mean(axis=0)


def map_(pos_index, pos_len):
    """MAP with min(m, N) normalization (matrics.py:63-86)."""
    n, k = pos_index.shape
    ranks = np.arange(1, k + 1)
    pre = pos_index.cumsum(axis=1) / ranks
    sum_pre = np.cumsum(pre * pos_index.astype(np.float32), axis=1)
    actual_len = np.minimum(pos_len, k)
    col = np.broadcast_to(np.arange(k), (n, k))
    clamped_ranks = np.minimum(col + 1, np.maximum(actual_len, 1).reshape(-1, 1))
    return (sum_pre / clamped_ranks).mean(axis=0)


def precision_(pos_index, pos_len):
    """(matrics.py:89-102)"""
    rec = pos_index.cumsum(axis=1) / np.arange(1, pos_index.shape[1] + 1)
    return rec.mean(axis=0)


metrics_dict = {
    "ndcg": ndcg_,
    "recall": recall_,
    "recall2": recall2_,
    "precision": precision_,
    "map": map_,
}
