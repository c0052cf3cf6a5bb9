# coding: utf-8
"""Full-catalog top-k and its evaluators (counterpart of
`foodrec_tpu/engine/topk_evaluator.py`; reference
FoodRec/utils/topk_evaluator.py): `full_sort_topk` on the device,
`TopKEvaluator` (Recall, Recall2, Precision, NDCG and MAP at each `topk`
over the hit matrix, engine/matrics.py, and the top-k CSV dump) and
`sample_rank_metrics` on the host.

Answers "top-k recipes for these users": a users x items scoring sweep over
item chunks with a running top-k merge, so memory stays [B, k + chunk]. On
ties the lower item id wins, as in the JAX package's running `lax.top_k`
merge: the kept winners precede each new chunk and the sort is stable and in
`lax.top_k`'s order.

The blocks have the JAX package's fixed shapes (topk_evaluator.py:33-65):
the last user block is padded with user 0 to `user_batch`, and the last
item chunk to `item_chunk` with ids clamped to n_items - 1, whose scores are
set to -inf. A model whose scores mix the samples of a block (SCHGN's
faithful interleave) then scores every item as the JAX package does.

Under a mesh with a `model` axis, `distributed_full_sort_topk` splits the
catalog by item over the axis: each rank sweeps its shard, and the shards'
top-k lists are gathered and merged in the same order.
"""

import os

import numpy as np
import torch

from foodrec_tpu_torch.engine.evaluator import descending_order
from foodrec_tpu_torch.parallel.collectives import all_gather
from foodrec_tpu_torch.engine.matrics import metrics_dict
from foodrec_tpu_torch.utils.misc import get_local_time
from foodrec_tpu_torch.utils.trace import span

topk_metrics = {m.lower(): m for m in
                ["Recall", "Recall2", "Precision", "NDCG", "MAP"]}


def item_chunks(n_items, item_chunk, device, first=0, stop=None):
    """(ids, valid) of each chunk the sweep scores over items [first,
    stop) (default: the catalog): `item_chunk` ids, the last chunk's
    padding, and ids past the catalog, clamped to n_items - 1 and not
    valid."""
    stop = n_items if stop is None else stop
    for start in range(first, stop, item_chunk):
        ids = torch.arange(start, start + item_chunk, device=device)
        yield ids.clamp_max(n_items - 1), ids < min(stop, n_items)


def _block_topk(score_fn, blk, k, chunks):
    """The running top-k merge of one user block over the item chunks:
    (scores, ids) [B, k], descending, equal scores by lower id."""
    b = blk.shape[0]
    best_s = torch.full((b, k), -torch.inf, device=blk.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=blk.device)
    for items, valid in chunks:
        scores = torch.where(valid, score_fn(blk, items), -torch.inf)
        with span("topk_merge"):
            merged_s = torch.cat([best_s, scores], dim=1)
            merged_i = torch.cat([best_i, items.expand(b, -1)], dim=1)
            sel = descending_order(merged_s)[:, :k]
            best_s = merged_s.gather(1, sel)
            best_i = merged_i.gather(1, sel)
    return best_s, best_i


def _user_blocks(users, user_batch, device):
    """The users padded with user 0 to whole blocks of `user_batch`."""
    users = torch.as_tensor(users).to(device=device, dtype=torch.int64)
    users = torch.cat([users, users.new_zeros((-len(users)) % user_batch)])
    return [users[s:s + user_batch] for s in range(0, len(users), user_batch)]


def full_sort_topk(score_fn, users, n_items, k, user_batch=64,
                   item_chunk=8192, device="cuda"):
    """Top-k item ids per user, int64 [U, k] on the CPU.

    score_fn(users int64 [B], items int64 [C]) -> float32 [B, C] scores of
    each user in the block against one shared list of item ids.
    """
    with span("topk_request"):
        out = [_block_topk(score_fn, blk, k,
                           item_chunks(n_items, item_chunk, device))[1]
               for blk in _user_blocks(users, user_batch, device)]
        return torch.cat(out)[:len(users)].cpu()


def distributed_full_sort_topk(mesh, score_fn, users, n_items, k,
                               user_batch=64, item_chunk=8192, device="cuda"):
    """`full_sort_topk` with the catalog split by item over the mesh's
    `model` axis (topk_evaluator.py:68-135): the catalog padded to a
    multiple of the axis, the pad at -inf; each rank sweeps its shard of
    items for a local top-min(k, shard), then the [B, k'] scores and ids of
    every shard are gathered over `model` and merged in the same order
    (descending, equal scores by lower id, the shards' lists in item
    order), so the ids equal `full_sort_topk`'s. Per user block the
    traffic is O(shards * k); the scores never leave their rank.
    score_fn is full_sort_topk's; every `data` rank computes the same."""
    n_sh, i = mesh.size("model"), mesh.index("model")
    group = mesh.group("model")
    shard = -(-n_items // n_sh)
    local_k = min(k, shard)
    out = []
    with span("topk_request"):
        for blk in _user_blocks(users, user_batch, device):
            best_s, best_i = _block_topk(
                score_fn, blk, local_k,
                item_chunks(n_items, min(item_chunk, shard), device,
                            first=i * shard, stop=(i + 1) * shard))
            b = blk.shape[0]
            all_s = all_gather(best_s, group).reshape(n_sh, b, local_k)
            all_i = all_gather(best_i, group).reshape(n_sh, b, local_k)
            with span("topk_merge"):
                all_s = all_s.transpose(0, 1).reshape(b, n_sh * local_k)
                all_i = all_i.transpose(0, 1).reshape(b, n_sh * local_k)
                sel = descending_order(all_s)[:, :k]
                out.append(all_i.gather(1, sel))
        return torch.cat(out)[:len(users)].cpu()


class TopKEvaluator:
    """Metrics of a top-k list per user (topk_evaluator.py:142-207): keys
    are the lower-case metric names at each k (`recall@20`), rounded to 4
    places."""

    def __init__(self, config):
        self.config = config
        self.metrics = config["metrics"]
        self.topk = config["topk"]
        self.save_recom_result = config["save_recommended_topk"]
        self._check_args()

    def evaluate(self, topk_index, eval_data, is_test=False, idx=0):
        """topk_index: [U, max_k] item ids; eval_data = (pos_user, pos_items,
        pos_len_list). On the test split with `save_recommended_topk`, the
        top-k lists go to `{recommend_topk}/{model}-{dataset}-idx{idx}-
        top{max_k}-{time}.csv`, in the JAX package's format: a tab-separated
        `id top_0 ... top_{k-1}` header, then one row of ints a user."""
        pos_user, pos_items, pos_len_list = eval_data
        pos_len = np.asarray(pos_len_list)
        topk_index = np.asarray(topk_index)

        if self.save_recom_result and is_test:
            max_k = max(self.topk)
            dir_name = os.path.abspath(self.config["recommend_topk"]
                                       or "recommend_topk/")
            os.makedirs(dir_name, exist_ok=True)
            file_path = os.path.join(dir_name, "{}-{}-idx{}-top{}-{}.csv".format(
                self.config["model"], self.config["dataset"], idx, max_k,
                get_local_time()))
            rows = np.column_stack([np.asarray(pos_user, np.int64),
                                    topk_index.astype(np.int64)])
            header = "\t".join(["id"] + [f"top_{i}" for i in range(max_k)])
            np.savetxt(file_path, rows, fmt="%d", delimiter="\t",
                       header=header, comments="")

        if len(pos_len) != len(topk_index):
            raise ValueError(f"{len(pos_len)} users' positives for "
                             f"{len(topk_index)} top-k rows")
        bool_rec = np.zeros(topk_index.shape, dtype=bool)
        for row, (m, n) in enumerate(zip(pos_items, topk_index)):
            bool_rec[row] = np.isin(n, np.asarray(m))

        metric_dict = {}
        for metric in self.metrics:
            value = metrics_dict[metric.lower()](bool_rec, pos_len)
            for k in self.topk:
                metric_dict[f"{metric}@{k}"] = round(float(value[k - 1]), 4)
        return metric_dict

    def _check_args(self):
        if isinstance(self.metrics, str):
            self.metrics = [self.metrics]
        if not isinstance(self.metrics, list):
            raise TypeError("metrics must be str or list")
        for m in self.metrics:
            if m.lower() not in topk_metrics:
                raise ValueError(
                    f"There is no user grouped topk metric named {m}!")
        self.metrics = [m.lower() for m in self.metrics]

        if isinstance(self.topk, int):
            self.topk = [self.topk]
        if not isinstance(self.topk, list):
            raise TypeError("The topk must be a integer, list")
        for k in self.topk:
            if k <= 0:
                raise ValueError(
                    "topk must be a positive integer or a list of positive "
                    f"integers, but get `{k}`")

    def __str__(self):
        return ("The TopK Evaluator Info:\n\tMetrics:["
                + ", ".join(topk_metrics[m] for m in self.metrics)
                + "], TopK:[" + ", ".join(map(str, self.topk)) + "]")


def sample_rank_metrics(pred_list, neg_num):
    """Rank-of-positive metrics for the sampled path: candidates per row =
    [neg_1..neg_K, pos] (topk_evaluator.py:210-232; reference
    trainer.py:317-349). Host numpy; `neg_num` is unused, as there."""
    pred_list = np.asarray(pred_list)
    auc = np.sum(pred_list[:, :-1] < pred_list[:, -1:]) / (
        len(pred_list) * pred_list.shape[1] - len(pred_list))
    rank = (-pred_list).argsort().argsort()[:, -1]

    mrr = float(np.mean(1.0 / (rank + 1.0)))
    hits, ndcgs = {}, {}
    for k in (1, 5, 10, 20):
        hit = rank < k
        hits[f"HIT@{k}"] = float(np.mean(hit))
        ndcgs[f"NDCG@{k}"] = float(np.mean(
            np.where(hit, 1.0 / np.log2(rank + 2.0), 0.0)))
    # the reference dict's key order: AUC, MRR, HIT@*, NDCG@*
    return {"AUC": float(auc), "MRR": mrr, **hits, **ndcgs}
