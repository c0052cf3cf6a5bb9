# coding: utf-8
"""Self-supervised objectives (counterpart of
`foodrec_tpu/common/ssl_losses.py`; reference
FoodRec/models/pricai_modelx.py).

`correlation_distance` (dCor) is the loss CLUSSL (PRICAI_ModelX) ships with
(pricai_modelx.py:409-437); the others are the reference's alternative CL
objectives, kept as utilities: InfoNCE `cl_loss` (:354-378), poly-view CL
(:324-351), min-mutual-information (:380-393) and orthogonal (:395-406).
Plain tensor math; the [B, B] products are matmuls.
"""

import math

import torch

from foodrec_tpu_torch.common.loss import cosine, safe_l2_norm


def _l2_normalize(x, dim=-1, eps=1e-12):
    return x / (safe_l2_norm(x, dim=dim, keepdim=True) + eps)


def correlation_distance(x, y):
    """Distance correlation between two [B, D] batches
    (pricai_modelx.py:409-437)."""

    def centered_distance(X):
        r = (X * X).sum(1, keepdim=True)
        D = torch.sqrt((r - 2 * X @ X.T + r.T).clamp_min(0.0) + 1e-8)
        return (D - D.mean(0, keepdim=True) - D.mean(1, keepdim=True)
                + D.mean())

    def distance_covariance(D1, D2):
        n = D1.shape[0]
        return torch.sqrt(((D1 * D2).sum() / (n * n)).clamp_min(0.0) + 1e-8)

    D1 = centered_distance(x)
    D2 = centered_distance(y)
    dcov_12 = distance_covariance(D1, D2)
    dcov_11 = distance_covariance(D1, D1)
    dcov_22 = distance_covariance(D2, D2)
    return dcov_12 / torch.sqrt((dcov_11 * dcov_22).clamp_min(0.0) + 1e-10)


def cl_loss(hidden, hidden_norm=True, temperature=0.5):
    """SimCLR-style InfoNCE over a [2B, D] stack of two views
    (pricai_modelx.py:354-378; the reference divides by the batch size)."""
    batch = hidden.shape[0] // 2
    large = 1e9
    if hidden_norm:
        hidden = _l2_normalize(hidden)
    h1, h2 = hidden[:batch], hidden[batch:]
    mask = torch.eye(batch, dtype=hidden.dtype, device=hidden.device)
    idx = torch.arange(batch, device=hidden.device)

    logits_aa = h1 @ h1.T / temperature - mask * large
    logits_bb = h2 @ h2.T / temperature - mask * large
    logits_ab = h1 @ h2.T / temperature
    logits_ba = h2 @ h1.T / temperature

    def xent(logits):
        return -torch.log_softmax(logits, dim=1)[idx, idx].mean()

    loss_a = xent(torch.cat([logits_ab, logits_aa], dim=1))
    loss_b = xent(torch.cat([logits_ba, logits_bb], dim=1))
    return (loss_a + loss_b) / batch


def poly_view_cl(i1, i2, i3, tau=0.5, method="arithmetic"):
    """Poly-view contrastive loss over three [k, d] views
    (pricai_modelx.py:324-351)."""
    z = _l2_normalize(torch.stack([i1, i2, i3], dim=1))   # [k, m, d]
    k, m, _ = z.shape
    scores = torch.einsum("jmd,knd->jmnk", z, z) / tau
    eye = torch.eye(k, dtype=z.dtype, device=z.device).reshape(k, 1, k)
    rows = torch.arange(k, device=z.device)

    losses_alpha = []
    for alpha in range(m):
        per_beta = []
        for beta in range(m):
            if alpha == beta:
                continue
            mask_beta = torch.ones((1, m, 1), dtype=z.dtype, device=z.device)
            mask_beta[:, beta, :] = 0.0
            logits = scores[:, alpha] - mask_beta * eye * 1e6
            logits = logits.reshape(k, m * k)
            lsm = torch.log_softmax(logits, dim=1)
            per_beta.append(-lsm[rows, rows + beta * k].mean())
        stacked = torch.stack(per_beta, dim=-1)
        if method == "arithmetic":
            losses_alpha.append(torch.logsumexp(stacked, dim=-1) - math.log(k))
        else:
            losses_alpha.append(stacked.mean(-1))
    return torch.stack(losses_alpha, dim=-1).mean()


def min_mutual_information(a, b, c):
    """(pricai_modelx.py:380-393)"""

    def term(x, y):
        return -torch.log(1 - cosine(x, y).mean() + 1e-8)

    return (term(a, b) + term(a, c) + term(b, c)) / 3


def orthogonal_loss(a, b, c):
    """(pricai_modelx.py:395-406)"""

    def term(x, y):
        return ((x * y).sum(1) ** 2).mean()

    return term(a, b) + term(a, c) + term(b, c)
