# coding: utf-8
"""Device-ready dataset arrays (counterpart of `foodrec_tpu/data/device.py`).

  * train interactions as flat int32 arrays
  * a packed uint32 positive bitmap per user (train and valid/test positives)
    for the on-device negative sampler (replaces the reference's rejection
    test, dataloader.py:145-151)
  * the item side tables (image, text, ingredient codes and counts, health
    multi-hot, calorie level, scalar health level) that the model gathers
    per batch
  * the health-stratified negatives' buckets: the items of each health
    level, padded with -1, the users who draw from them and the train item
    list the others draw from (dataloader.py:22-25, 87-114)
  * eval candidate sets as one padded [U, C] block per split (replaces the
    reference's per-user generator EvalByUserDataloader,
    dataloader.py:228-302)

Built with vectorized numpy instead of the JAX package's native extension.
The port's FoodData loads a file only under its config flag, so an array
is built here where its dataset attribute exists, as the JAX package builds
it where the flag is set.
"""

import dataclasses
from typing import Optional

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


def _pack_bitmap(pairs_u, pairs_i, n_users, n_items):
    """bit i of row u set for every (u, i) pair: uint32 [n_users,
    ceil(n_items / 32)]."""
    words = _round_up(n_items, 32) // 32
    bitmap = np.zeros((n_users, words), dtype=np.uint32)
    np.bitwise_or.at(bitmap, (pairs_u, pairs_i >> 5),
                     np.uint32(1) << (pairs_i & 31).astype(np.uint32))
    return bitmap


@dataclasses.dataclass
class DeviceData:
    """The arrays a model and its trainer need, as host numpy ready for the
    device."""

    n_users: int
    n_items: int
    num_users: int      # train-file derived (dataset.py:30); the sampler
    num_items: int      # draws from [0, num_items) (dataloader.py:147)
    n_ingredients: int

    train_u: np.ndarray           # int32 [n_train]
    train_i: np.ndarray           # int32 [n_train]
    excl_bitmap: np.ndarray       # uint32 [num_users, ceil(num_items/32)]

    img: np.ndarray               # float32 [n_items, D_img]
    txt: np.ndarray               # float32 [n_items, D_txt]
    ingre_codes: np.ndarray       # int32 [n_items, 20]
    ingre_num: np.ndarray         # int32 [n_items]
    health_mh: Optional[np.ndarray]  # float32 [n_items, H], or None

    eval_valid: EvalSet
    eval_test: EvalSet

    cal_level: Optional[np.ndarray] = None     # int32 [n_items], or None
    health_level: Optional[np.ndarray] = None  # int32 [n_items], or None

    # health-stratified second negatives (dataloader.py:22-25, 87-114)
    health_bucket_items: Optional[np.ndarray] = None  # int32 [6, L], pad -1
    health_in_sample: Optional[np.ndarray] = None     # bool [num_users]
    train_items_arr: Optional[np.ndarray] = None      # int32 [n_train_items]

    @property
    def n_train(self):
        return len(self.train_u)

    @classmethod
    def from_food_data(cls, dataset):
        n_users, n_items = dataset.num_users, dataset.num_items
        train_u = dataset._train_u.astype(np.int32)
        train_i = dataset._train_i.astype(np.int32)

        # exclusion = train positives and valid/test positives
        # (dataloader.py:149)
        ex_u, ex_i = [train_u.astype(np.int64)], [train_i.astype(np.int64)]
        for u, items in dataset.validTestRatings.items():
            if items:
                ex_u.append(np.full(len(items), u, dtype=np.int64))
                ex_i.append(np.fromiter(items, dtype=np.int64))
        excl = _pack_bitmap(np.concatenate(ex_u), np.concatenate(ex_i),
                            n_users, n_items)

        health_mh = None
        mh = getattr(dataset, "health_level_multi_hot", None)
        if mh is not None:
            health_mh = np.zeros((dataset.n_items, len(mh[0])),
                                 dtype=np.float32)
            for k, v in mh.items():
                health_mh[k] = np.asarray(v, dtype=np.float32)
        def dict_to_array(d):
            """An item -> level dict as int32 [n_items]; unlisted items 0."""
            if d is None:
                return None
            arr = np.zeros(dataset.n_items, dtype=np.int32)
            for k, v in d.items():
                arr[k] = v
            return arr

        # loaded under use_cal_level and use_health_level (dataset.py)
        cal_level = dict_to_array(getattr(dataset, "cal_level", None))
        health_level = dict_to_array(getattr(dataset, "health_level", None))

        health_bucket_items = health_in_sample = train_items_arr = None
        if hasattr(dataset, "neg_sample_set"):  # health_neg_sample
            # buckets keyed by the positive item's health level; users
            # outside neg_sample_set draw uniformly over the train items
            if health_level is None:
                raise ValueError(
                    "health_neg_sample requires use_health_level "
                    "(reference reads dataset.health_level[pos_i_id])")
            buckets = [getattr(dataset, f"health_{b}") for b in range(6)]
            width = max((len(b) for b in buckets), default=0) or 1
            health_bucket_items = np.full((6, width), -1, dtype=np.int32)
            for bi, b in enumerate(buckets):
                health_bucket_items[bi, :len(b)] = np.asarray(b, np.int32)
            health_in_sample = np.zeros(n_users, dtype=bool)
            idx = np.asarray(sorted(dataset.neg_sample_set), dtype=np.int64)
            health_in_sample[idx[idx < n_users]] = True
            train_items_arr = np.asarray(dataset.train_item_list,
                                         dtype=np.int32)

        eval_valid = build_eval_set(dataset.valid_users, dataset.validRatings,
                                    dataset.validNegatives)
        eval_test = build_eval_set(list(range(n_users)),
                                   dataset.testRatings, dataset.testNegatives)
        return cls(
            n_users=dataset.n_users, n_items=dataset.n_items,
            num_users=n_users, num_items=n_items,
            n_ingredients=dataset.num_ingredients,
            train_u=train_u, train_i=train_i, excl_bitmap=excl,
            img=np.asarray(dataset.embImage, dtype=np.float32),
            txt=np.asarray(dataset.embText, dtype=np.float32),
            ingre_codes=np.asarray(dataset.ingredientCodeDict, dtype=np.int32),
            ingre_num=np.asarray(dataset.ingredientNum, dtype=np.int32),
            health_mh=health_mh,
            eval_valid=eval_valid, eval_test=eval_test, cal_level=cal_level,
            health_level=health_level,
            health_bucket_items=health_bucket_items,
            health_in_sample=health_in_sample,
            train_items_arr=train_items_arr,
        )
