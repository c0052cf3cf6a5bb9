# coding: utf-8
"""The losses CIKM_Model trains on (counterpart of `foodrec_tpu/common/loss.py`;
reference FoodRec/common/loss.py).

Every loss takes tensors and returns a scalar. `weight` is the per-row
sample weight: the JAX epoch always passes one (trainer.py:269, 276), so the
port has the weighted formulas only.
"""

import torch


def safe_l2_norm(x, dim=-1, keepdim=False):
    """The L2 norm over `dim`, with gradient 0 (torch's subgradient
    convention) instead of NaN at an all-zero vector."""
    sq = (x * x).sum(dim, keepdim=keepdim)
    nonzero = sq > 0
    # double where: keep both the value and the sqrt backward off sq == 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)


def bpr_loss(pos_score, neg_score, weight, gamma=1e-10):
    """-log(gamma + sigmoid(pos - neg)), the weighted mean over rows
    (reference loss.py:8-34)."""
    loss = -torch.log(gamma + torch.sigmoid(pos_score - neg_score))
    return (loss * weight).sum() / weight.sum().clamp_min(1.0)


def emb_loss(*embeddings, weight):
    """Sum of the L2 norms (not squared) of each tensor, each row scaled by
    its weight, over the weight sum (reference loss.py:37-50)."""
    total = 0.0
    for e in embeddings:
        w = weight.reshape((-1,) + (1,) * (e.dim() - 1))
        total = total + torch.sqrt(((e * w) ** 2).sum() + 1e-24)
    return total / weight.sum().clamp_min(1.0)
