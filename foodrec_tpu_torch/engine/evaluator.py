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

On the card a block's metrics are one launch of the hand-written kernel
`csrc/by_user_metrics.cu` (`ops/_kernels.py` `by_user_metrics`), which
gives the plain version's values bit for bit; CPU tensors take the plain
version, `by_user_metrics_plain`.

An EvalSet's arrays are copied to the device, int64 and padded to whole
blocks, on the first pass over the set on that device at that block size,
and held for the later passes while the set lives (`copies` counts the
copies); so an EvalSet's arrays must not be written after it is built.
"""

import functools
import weakref

import numpy as np
import torch

from foodrec_tpu_torch.ops import _kernels
from foodrec_tpu_torch.utils.trace import span

NEG_INF = -1e30
TOP_K = 20  # the ranks Recall and NDCG read (the kernel's kMaxK)
METRICS = ("auc", "recall@10", "recall@20", "ndcg@10", "ndcg@20")
_LOG2_E = torch.tensor(1.0 / np.log(2.0), dtype=torch.float32)

# eval sets copied to a device since the caller last reset it
copies = 0

# EvalSet -> {(device, block size): its padded device arrays}; an entry
# goes with its set
_resident = weakref.WeakKeyDictionary()


def _order_key(bits):
    """int32 bits of float32 values (a tensor or an int) to keys monotone
    in the float total order."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


# the key of a masked slot's score, float32 NEG_INF
_MASKED_KEY = _order_key(int(np.float32(NEG_INF).view(np.int32)))


def descending_order(x):
    """Indices sorting each row of float32 `x` as `jax.lax.top_k` does:
    descending in the float total order, equal values by lower index."""
    key = _order_key(x.contiguous().view(torch.int32))
    return torch.sort(key, dim=1, descending=True, stable=True).indices


@functools.lru_cache(maxsize=None)
def _rank_gains():
    """1 / log2(rank + 2) for the top TOP_K ranks in float32, computed on
    the CPU once (read only: every caller shares the tensor)."""
    r = torch.arange(TOP_K, dtype=torch.float32) + 2.0
    return 1.0 / (torch.log(r) * _LOG2_E)


def _sum_left_to_right(x):
    """Row sums of a [B, K] float32 tensor, added in column order."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def by_user_metrics(scores, n_pos, n_cand, neg_num):
    """Per-user metrics from padded candidate scores.

    scores: float32 [B, C]  (padded slots may hold junk; masked here)
    n_pos:  int [B]         positives occupy slots [0, n_pos)
    n_cand: int [B]         valid slots are [0, n_cand)
    Returns dict of float32 [B] tensors: auc, recall@10/20, ndcg@10/20.
    On the card, one launch of the kernel (rows of 20 to
    `_kernels.METRICS_MAX_WIDTH` slots; it raises on others); on the CPU,
    the plain version.
    """
    if scores.device.type != "cuda":
        return by_user_metrics_plain(scores, n_pos, n_cand, neg_num)
    out = _kernel_block(scores, n_pos, n_cand, neg_num)
    return dict(zip(METRICS, out.unbind(1)))


def _kernel_block(scores, n_pos, n_cand, neg_num):
    """One launch of the kernel: float32 [B, 5], the columns METRICS."""
    return _kernels.by_user_metrics(
        scores.contiguous(), n_pos.long().contiguous(),
        n_cand.long().contiguous(), _rank_gains(), neg_num, _MASKED_KEY)


def by_user_metrics_plain(scores, n_pos, n_cand, neg_num):
    """by_user_metrics in PyTorch ops, on any device."""
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
    hit = descending_order(masked)[:, :TOP_K] < n_pos[:, None]
    ranks = torch.arange(TOP_K, device=scores.device)[None, :]
    gains = _rank_gains().to(scores.device)

    out = {"auc": auc}
    for k in (10, 20):
        hk = hit[:, :k]
        dcg = _sum_left_to_right(hk * gains[:k])
        ideal = ranks[:, :k] < torch.clamp(n_pos, max=k)[:, None]
        idcg = _sum_left_to_right(ideal * gains[:k])
        out[f"ndcg@{k}"] = dcg / torch.clamp(idcg, min=1e-12)
        out[f"recall@{k}"] = hk.sum(dim=1) / n_pos_1
    return out


def _device_arrays(eval_set, batch_size, device):
    """(users, cand, n_pos, n_cand) of `eval_set` on `device`, int64, each
    padded with zero rows to a multiple of `batch_size`: copied on the
    first call for the set, device and block size, and held while the set
    lives. A set that cannot key a weak dictionary (a `SimpleNamespace`
    cannot be weakly referenced, the JAX package's EvalSet cannot be
    hashed) is copied on every call."""
    global copies
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        held = _resident.setdefault(eval_set, {})
    except TypeError:
        held = {}
    key = (device, batch_size)
    if key not in held:
        pad = (-eval_set.n_users) % batch_size

        def put(a):
            a = torch.as_tensor(a).to(device=device, dtype=torch.int64)
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

        held[key] = (put(eval_set.users), put(eval_set.cand),
                     put(eval_set.n_pos), put(eval_set.n_cand))
        copies += 1
    return held[key]


def evaluate_by_user(score_fn, eval_set, neg_num, batch_size=256,
                     device="cuda", return_per_user=False):
    """Run the by-user eval over a padded EvalSet on `device`.

    score_fn(users int64 [B], cand int64 [B, C]) -> float32 [B, C], called on
    consecutive user blocks of exactly `batch_size`: the last block is
    padded with user 0 and zero candidate rows, as the JAX package pads it
    (evaluator.py:95-100), and the pad rows are dropped from the metrics. A
    model whose scores mix the samples of a block (SCHGN's faithful
    interleave) scores the last block's users as the JAX package does.

    Returns (valid_score, metrics_dict) with the reference's metric keys
    (AUC, Recall@10/20, NDCG@10/20); valid_score = NDCG@20
    (trainer.py:272-282). With `return_per_user`, (valid_score, metrics,
    per-user metric arrays, the scores [U, C]) as host numpy, as the JAX
    package returns them (evaluator.py:114-137).
    """
    u = eval_set.n_users
    with span("eval_upload"):
        users, cand, n_pos, n_cand = _device_arrays(eval_set, batch_size,
                                                    device)

    blocks, preds = [], []
    for s in range(0, len(users), batch_size):
        e = s + batch_size
        scores = score_fn(users[s:e], cand[s:e])
        with span("metrics"):
            if scores.device.type == "cuda":
                m = _kernel_block(scores, n_pos[s:e], n_cand[s:e], neg_num)
            else:
                m = by_user_metrics_plain(scores, n_pos[s:e], n_cand[s:e],
                                          neg_num)
                m = torch.stack([m[k] for k in METRICS], 1)
            blocks.append(m)
        if return_per_user:
            preds.append(scores)

    # one copy to the host a pass; each metric's column made contiguous, so
    # that numpy's means add as they did over separate arrays
    columns = torch.cat(blocks)[:u].cpu().numpy()
    per_user = {k: np.ascontiguousarray(columns[:, i])
                for i, k in enumerate(METRICS)}
    # numpy float32 means, as the JAX package takes them
    metrics = {
        "AUC": float(per_user["auc"].mean()),
        "Recall@10": float(per_user["recall@10"].mean()),
        "Recall@20": float(per_user["recall@20"].mean()),
        "NDCG@10": float(per_user["ndcg@10"].mean()),
        "NDCG@20": float(per_user["ndcg@20"].mean()),
    }
    if return_per_user:
        return (metrics["NDCG@20"], metrics, per_user,
                torch.cat(preds)[:u].cpu().numpy())
    return metrics["NDCG@20"], metrics
