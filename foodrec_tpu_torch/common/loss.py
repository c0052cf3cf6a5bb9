# coding: utf-8
"""The losses the ported models train on (counterpart of
`foodrec_tpu/common/loss.py`; reference FoodRec/common/loss.py).

Every loss takes tensors and returns a scalar. `weight` is the per-row
sample weight: the JAX epoch always passes one (trainer.py:269, 276), so the
batch losses take the weighted formulas. `emb_loss` without a weight is the
reference's own form, which BM3 applies to whole propagated tables.

A weighted loss reduces over the batch's rows through `batch_sum`: under a
`data` mesh it is the global batch's value on every rank
(parallel/mesh.py).
"""

import torch

from foodrec_tpu_torch.parallel.mesh import batch_sum


def safe_l2_norm(x, dim=-1, keepdim=False):
    """The L2 norm over `dim`, with gradient 0 (torch's subgradient
    convention) instead of NaN at an all-zero vector."""
    sq = (x * x).sum(dim, keepdim=keepdim)
    nonzero = sq > 0
    # double where: keep both the value and the sqrt backward off sq == 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)


def normalize(x, dim):
    """F.normalize: x / max(||x||, 1e-12) along `dim`, with a finite
    gradient at 0."""
    return x / safe_l2_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def cosine(a, b):
    """Cosine along the last dim with each norm clamped to 1e-8 on its own
    (not F.cosine_similarity's clamp of the product), as the JAX package
    computes it."""
    na = safe_l2_norm(a).clamp_min(1e-8)
    nb = safe_l2_norm(b).clamp_min(1e-8)
    return (a * b).sum(-1) / (na * nb)


def bpr_loss(pos_score, neg_score, weight, gamma=1e-10):
    """-log(gamma + sigmoid(pos - neg)), the weighted mean over rows
    (reference loss.py:8-34)."""
    loss = -torch.log(gamma + torch.sigmoid(pos_score - neg_score))
    return batch_sum(loss * weight) / batch_sum(weight).clamp_min(1.0)


def emb_loss(*embeddings, weight=None):
    """Sum of the L2 norms (not squared) of each tensor over a row count
    (reference loss.py:37-50): with `weight`, each row scaled by its weight
    over the weight sum; without, the plain norms over the row count of the
    last tensor."""
    if weight is None:
        total = sum(torch.linalg.vector_norm(e.reshape(-1))
                    for e in embeddings)
        return total / embeddings[-1].shape[0]
    total = 0.0
    for e in embeddings:
        w = weight.reshape((-1,) + (1,) * (e.dim() - 1))
        total = total + torch.sqrt(batch_sum((e * w) ** 2) + 1e-24)
    return total / batch_sum(weight).clamp_min(1.0)


def l2_loss(*embeddings, weight=None):
    """0.5 * the sum of squared entries, summed over the tensors, each row
    scaled by its weight when one is given (reference loss.py:53-60)."""
    total = 0.0
    for e in embeddings:
        if weight is None:
            total = total + 0.5 * (e ** 2).sum()
        else:
            e = e * weight.reshape((-1,) + (1,) * (e.dim() - 1))
            total = total + 0.5 * batch_sum(e ** 2)
    return total
