# coding: utf-8
"""Batched by-user evaluation (counterpart of
`foodrec_tpu/engine/evaluator.py`; reference FoodRec/common/trainer.py:231-282
with EvalByUserDataloader, utils/dataloader.py:228-302).

Semantics kept exactly:
  * candidate list per user = [positives..., negatives-minus-dup-pos...]
    (a padded [U, C] EvalSet, data/device.py)
  * AUC = mean over positives of #(neg_score < pos_score) / (n_pos * neg_num),
    strict <, with neg_num = config['neg_sample_num'] whatever the actual
    negative count (trainer.py:49-52)
  * ranking = scores sorted descending in `jax.lax.top_k`'s order: floats
    in their total order (-0.0 below +0.0) and ties to the lower slot, so
    positives (which lead) win ties. A stable descending `torch.sort` of
    total-order keys gives that order; `torch.topk` promises none.
  * Recall@k = hits/n_pos, NDCG@k with IDCG truncated at min(k, n_pos)
  * the valid score is NDCG@20

Per-user values equal the JAX package's bit for bit on the CPU: the rank
gains repeat XLA's lowering of `jnp.log2` (log(x) * f32(1/ln 2)) and the
gain sums run left to right, as XLA reduces these short rows.
"""

import numpy as np
import torch

NEG_INF = -1e30
_LOG2_E = torch.tensor(1.0 / np.log(2.0), dtype=torch.float32)


def descending_order(x):
    """Indices sorting each row of float32 `x` as `jax.lax.top_k` does:
    descending in the float total order, equal values by lower index."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone in the total order
    return torch.sort(key, dim=1, descending=True, stable=True).indices


def _rank_gains(max_k, device):
    """1 / log2(rank + 2) in float32, computed on the CPU."""
    r = torch.arange(max_k, dtype=torch.float32) + 2.0
    return (1.0 / (torch.log(r) * _LOG2_E)).to(device)


def _sum_left_to_right(x):
    """Row sums of a [B, K] float32 tensor, added in column order."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def by_user_metrics(scores, n_pos, n_cand, neg_num, max_k=20):
    """Per-user metrics from padded candidate scores.

    scores: float32 [B, C]  (padded slots may hold junk; masked here)
    n_pos:  int [B]         positives occupy slots [0, n_pos)
    n_cand: int [B]         valid slots are [0, n_cand)
    Returns dict of float32 [B] tensors: auc, recall@10/20, ndcg@10/20.
    """
    b, c = scores.shape
    slot = torch.arange(c, device=scores.device)[None, :]
    valid = slot < n_cand[:, None]
    is_pos = slot < n_pos[:, None]
    is_neg = valid & ~is_pos
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))

    # ---- AUC (pairwise, strict <) -------------------------------------------
    less = scores[:, None, :] < scores[:, :, None]       # [B, Cpos, Cneg]
    pair = less & is_pos[:, :, None] & is_neg[:, None, :]
    n_pos_1 = torch.clamp(n_pos, min=1)
    auc = pair.sum(dim=(1, 2)) / (n_pos_1 * neg_num)

    # ---- ranking metrics ----------------------------------------------------
    # positive slots lead, so a top slot below n_pos is a hit
    hit = descending_order(masked)[:, :max_k] < n_pos[:, None]
    ranks = torch.arange(max_k, device=scores.device)[None, :]
    gains = _rank_gains(max_k, scores.device)

    out = {"auc": auc}
    for k in (10, 20):
        hk = hit[:, :k]
        dcg = _sum_left_to_right(hk * gains[:k])
        ideal = ranks[:, :k] < torch.clamp(n_pos, max=k)[:, None]
        idcg = _sum_left_to_right(ideal * gains[:k])
        out[f"ndcg@{k}"] = dcg / torch.clamp(idcg, min=1e-12)
        out[f"recall@{k}"] = hk.sum(dim=1) / n_pos_1
    return out


def evaluate_by_user(score_fn, eval_set, neg_num, batch_size=256,
                     device="cuda"):
    """Run the by-user eval over a padded EvalSet on `device`.

    score_fn(users int64 [B], cand int64 [B, C]) -> float32 [B, C], called on
    consecutive user blocks of at most `batch_size`.

    Returns (valid_score, metrics_dict) with the reference's metric keys
    (AUC, Recall@10/20, NDCG@10/20); valid_score = NDCG@20
    (trainer.py:272-282).
    """
    def put(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int64)

    users, cand = put(eval_set.users), put(eval_set.cand)
    n_pos, n_cand = put(eval_set.n_pos), put(eval_set.n_cand)

    keys = ("auc", "recall@10", "recall@20", "ndcg@10", "ndcg@20")
    per_user = {k: [] for k in keys}
    for s in range(0, len(users), batch_size):
        e = s + batch_size
        scores = score_fn(users[s:e], cand[s:e])
        m = by_user_metrics(scores, n_pos[s:e], n_cand[s:e], neg_num=neg_num)
        for k in keys:
            per_user[k].append(m[k])

    per_user = {k: torch.cat(v).cpu().numpy() for k, v in per_user.items()}
    # numpy float32 means, as the JAX package takes them
    metrics = {
        "AUC": float(per_user["auc"].mean()),
        "Recall@10": float(per_user["recall@10"].mean()),
        "Recall@20": float(per_user["recall@20"].mean()),
        "NDCG@10": float(per_user["ndcg@10"].mean()),
        "NDCG@20": float(per_user["ndcg@20"].mean()),
    }
    return metrics["NDCG@20"], metrics
