# coding: utf-8
"""Device-ready dataset arrays for serving (counterpart of
`foodrec_tpu/data/device.py`).

Eval candidate sets are one padded [U, C] block per split (replaces the
reference's per-user generator EvalByUserDataloader, dataloader.py:228-302),
built with vectorized numpy instead of the JAX package's native assembler.
The exclusion bitmap, the sampling buckets and the item side tables
(ingredient codes, health multi-hot) arrive with training.
"""

import dataclasses

import numpy as np


def _round_up(x, m):
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class EvalSet:
    """Padded per-user candidate lists: [positives, negatives-minus-dup-pos].

    Mirrors EvalByUserDataloader (dataloader.py:232-238): candidates =
    pos_items + (negatives with the first occurrence of each positive
    removed); the first `n_pos[u]` slots are the positives.
    """

    users: np.ndarray   # int32 [U]
    cand: np.ndarray    # int32 [U, C] candidate item ids (0-padded)
    n_pos: np.ndarray   # int32 [U]
    n_cand: np.ndarray  # int32 [U]

    @property
    def n_users(self):
        return len(self.users)

    @property
    def width(self):
        return self.cand.shape[1]


def build_eval_set(users, ratings, negatives, pad_multiple=128):
    """Build a padded EvalSet from per-user positive/negative lists.

    The width is round_up(max positives + max negatives, pad_multiple), as
    the JAX package's native assembler sets it for rectangular negatives.
    """
    n_u = len(ratings)
    pos_len = np.fromiter((len(p) for p in ratings), np.int64, n_u)
    neg_len = np.fromiter((len(n) for n in negatives), np.int64, n_u)
    pos = (np.concatenate([np.asarray(p, np.int64) for p in ratings])
           if n_u else np.zeros(0, np.int64))
    neg = (np.concatenate([np.asarray(n, np.int64) for n in negatives])
           if n_u else np.zeros(0, np.int64))
    pos_u = np.repeat(np.arange(n_u), pos_len)
    neg_u = np.repeat(np.arange(n_u), neg_len)

    # a negative is dropped when it is the first occurrence, within its
    # user's list, of one of that user's positives (dataloader.py:235-237)
    span = int(max(pos.max(initial=0), neg.max(initial=0))) + 1
    neg_key = neg_u * span + neg
    order = np.argsort(neg_key, kind="stable")
    first = np.ones(len(neg), bool)
    first[order[1:]] = neg_key[order[1:]] != neg_key[order[:-1]]
    keep = ~(first & np.isin(neg_key, pos_u * span + pos))

    n_keep = np.bincount(neg_u, weights=keep, minlength=n_u).astype(np.int64)
    width = _round_up(int(pos_len.max(initial=0) + neg_len.max(initial=0)),
                      pad_multiple)
    cand = np.zeros((n_u, width), dtype=np.int32)
    pos_start = np.concatenate([[0], np.cumsum(pos_len)[:-1]])
    cand[pos_u, np.arange(len(pos)) - pos_start[pos_u]] = pos
    kept_u = neg_u[keep]
    keep_start = np.concatenate([[0], np.cumsum(n_keep)[:-1]])
    slot = pos_len[kept_u] + np.arange(len(kept_u)) - keep_start[kept_u]
    cand[kept_u, slot] = neg[keep]
    return EvalSet(users=np.asarray(users, dtype=np.int32), cand=cand,
                   n_pos=pos_len.astype(np.int32),
                   n_cand=(pos_len + n_keep).astype(np.int32))


@dataclasses.dataclass
class DeviceData:
    """The arrays serving needs, as host numpy ready for the device."""

    n_users: int
    n_items: int
    num_users: int      # train-file derived (dataset.py:30)
    num_items: int
    n_ingredients: int

    eval_valid: EvalSet
    eval_test: EvalSet

    @classmethod
    def from_food_data(cls, dataset):
        eval_valid = build_eval_set(dataset.valid_users, dataset.validRatings,
                                    dataset.validNegatives)
        eval_test = build_eval_set(list(range(dataset.num_users)),
                                   dataset.testRatings, dataset.testNegatives)
        return cls(
            n_users=dataset.n_users, n_items=dataset.n_items,
            num_users=dataset.num_users, num_items=dataset.num_items,
            n_ingredients=dataset.num_ingredients,
            eval_valid=eval_valid, eval_test=eval_test,
        )
