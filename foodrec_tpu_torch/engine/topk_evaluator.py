# coding: utf-8
"""Full-catalog top-k (counterpart of `full_sort_topk` in
`foodrec_tpu/engine/topk_evaluator.py`; reference FoodRec/utils/topk_evaluator.py).

Answers "top-k recipes for these users": a users x items scoring sweep over
item chunks with a running top-k merge, so memory stays [B, k + chunk]. On
ties the lower item id wins, as in the JAX package's running `lax.top_k`
merge: the kept winners precede each new chunk and the sort is stable and in
`lax.top_k`'s order.
"""

import torch

from foodrec_tpu_torch.engine.evaluator import descending_order


def full_sort_topk(score_fn, users, n_items, k, user_batch=64,
                   item_chunk=8192, device="cuda"):
    """Top-k item ids per user, int64 [U, k] on the CPU.

    score_fn(users int64 [B], items int64 [C]) -> float32 [B, C] scores of
    each user in the block against one shared list of item ids.
    """
    users = torch.as_tensor(users).to(device=device, dtype=torch.int64)
    out = []
    for s in range(0, len(users), user_batch):
        blk = users[s:s + user_batch]
        best_s = torch.full((len(blk), k), -torch.inf, device=device)
        best_i = torch.zeros((len(blk), k), dtype=torch.int64, device=device)
        for start in range(0, n_items, item_chunk):
            items = torch.arange(start, min(start + item_chunk, n_items),
                                 device=device)
            merged_s = torch.cat([best_s, score_fn(blk, items)], dim=1)
            merged_i = torch.cat([best_i, items.expand(len(blk), -1)], dim=1)
            sel = descending_order(merged_s)[:, :k]
            best_s = merged_s.gather(1, sel)
            best_i = merged_i.gather(1, sel)
        out.append(best_i)
    return torch.cat(out).cpu()
