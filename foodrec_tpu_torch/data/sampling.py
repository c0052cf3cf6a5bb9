# coding: utf-8
"""On-device sampling for the train epoch (counterpart of
`foodrec_tpu/data/sampling.py`).

Replaces the reference dataloader's host rejection loops with a fixed number
of draws T, the first acceptable draw taken and the last one if all T fail:

  * negative items: uniform, excluding the user's train and valid/test
    positives (dataloader.py:145-151). With an exclusion mass of a few
    percent, P(all 32 collide) < 1e-20.
  * the health-stratified second negative (dataloader.py:22-25, 87-114):
    from the health bucket of the positive item for users in
    `neg_sample_set`, uniform over the train item list for the others,
    tested against the same exclusion bitmap
  * SCHGN's masked-ingredient task (dataloader.py:117-143, utils.py:186-190):
    real ingredient slots masked with probability 0.2, and a negative
    ingredient per masked slot that is not in the recipe.

The packed bitmap is an int32 view of the JAX package's uint32 words
(torch.uint32 has few CUDA ops); `(word >> bit) & 1` reads the same bit
either way.
"""

import torch

from foodrec_tpu_torch.parallel.mesh import batch_draw


def is_excluded(excl_bitmap, users, items):
    """True where `items` is a positive of `users` in the packed bitmap."""
    words = excl_bitmap[users, items >> 5]
    return ((words >> (items & 31)) & 1).bool()


def sample_negatives(users, excl_bitmap, num_items, generator, n_tries=32):
    """One negative item per user, uniform over [0, num_items) minus the
    user's positives. users: int64 [B] on the bitmap's device; returns int64
    [B]."""
    b = users.shape[0]
    draws = torch.randint(0, num_items, (n_tries, b), generator=generator,
                          device=users.device)
    ok = ~is_excluded(excl_bitmap, users.expand(n_tries, b), draws)
    # the first accepted draw (argmax returns the first maximum), else the
    # last draw
    first_ok = ok.to(torch.uint8).argmax(dim=0)
    pick = torch.where(ok.any(dim=0), first_ok, n_tries - 1)
    return draws[pick, torch.arange(b, device=users.device)]


INT32_MAX = 2 ** 31 - 1


def health_negative_draws(users, generator, n_tries=32):
    """The health sampler's raw draws: int64 [n_tries, B], uniform in
    [0, int32 max), as the JAX package draws them."""
    return torch.randint(0, INT32_MAX, (n_tries, users.shape[0]),
                         generator=generator, device=users.device)


def pick_health_negatives(draws, users, pos_items, excl_bitmap, health_level,
                          bucket_items, in_sample_set, train_items):
    """One health-stratified negative per sample from `draws` [T, B]
    (foodrec_tpu/data/sampling.py:42-77): a user in `in_sample_set` takes
    slot `draw % len(bucket)` of the bucket of its positive item's health
    level; the others, and an empty bucket, take `train_items[draw %
    len(train_items)]`. The first candidate outside the user's positives is
    taken, else the last.

    health_level: int [num_items]; bucket_items: int [n_buckets, L] padded
    with -1; in_sample_set: bool [num_users]; train_items: int
    [n_train_items]. Returns int64 [B]."""
    n_tries, b = draws.shape
    lists = bucket_items[health_level[pos_items].long()].long()   # [B, L]
    lens = (lists >= 0).sum(1)                                    # [B]
    slots = draws % lens.clamp_min(1)[None, :]
    cand_b = lists.gather(1, slots.T).T.clamp_min(0)              # [T, B]
    cand_u = train_items.long()[draws % train_items.shape[0]]     # [T, B]
    use_bucket = in_sample_set[users] & (lens > 0)                # [B]
    cand = torch.where(use_bucket[None, :], cand_b, cand_u)
    ok = ~is_excluded(excl_bitmap, users.expand(n_tries, b), cand)
    first_ok = ok.to(torch.uint8).argmax(dim=0)
    pick = torch.where(ok.any(dim=0), first_ok, n_tries - 1)
    return cand[pick, torch.arange(b, device=users.device)]


def sample_health_stratified_negatives(users, pos_items, excl_bitmap,
                                       health_level, bucket_items,
                                       in_sample_set, train_items, generator,
                                       n_tries=32):
    """`n_tries` draws from `generator`, then `pick_health_negatives`."""
    draws = health_negative_draws(users, generator, n_tries)
    return pick_health_negatives(draws, users, pos_items, excl_bitmap,
                                 health_level, bucket_items, in_sample_set,
                                 train_items)


def ssl_mask_ingredients(ingre_codes, ingre_num, n_ingredients, generator,
                         masked_p=0.2, n_tries=16):
    """SCHGN's masked-ingredient sequences. ingre_codes: int64 [B, L], padded
    with n_ingredients; ingre_num: [B] real slots. Returns (masked_seq,
    pos_seq, neg_seq), int64 [B, L]: a real slot is masked with probability
    `masked_p` (token n_ingredients + 1) and gets, in neg_seq, the first of
    `n_tries` uniform ingredients that is not one of the recipe's real ones
    (the last draw if none is); pad and unmasked slots copy the code."""
    b, L = ingre_codes.shape
    dev = ingre_codes.device
    real = torch.arange(L, device=dev)[None, :] < ingre_num[:, None]
    # draws of the global batch's rows under a `data` mesh
    do_mask = (batch_draw(lambda s: torch.rand(s, generator=generator,
                                               device=dev), (b, L))
               < masked_p) & real
    masked_seq = torch.where(do_mask, n_ingredients + 1, ingre_codes)

    draws = batch_draw(lambda s: torch.randint(
        0, n_ingredients, s, generator=generator, device=dev),
        (n_tries, b, L), dim=1)
    real_codes = torch.where(real, ingre_codes, -1)
    in_recipe = (draws[..., None] == real_codes[None, :, None, :]).any(-1)
    ok = ~in_recipe                                        # [T, B, L]
    first_ok = ok.to(torch.uint8).argmax(dim=0)
    pick = torch.where(ok.any(dim=0), first_ok, n_tries - 1)
    neg_draw = draws.gather(0, pick[None])[0]
    neg_seq = torch.where(do_mask, neg_draw, ingre_codes)
    return masked_seq, ingre_codes, neg_seq
