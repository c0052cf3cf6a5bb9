# coding: utf-8
"""On-device sampling for the train epoch (counterpart of
`foodrec_tpu/data/sampling.py`).

Replaces the reference dataloader's host rejection loops with a fixed number
of draws T, the first acceptable draw taken and the last one if all T fail:

  * negative items: uniform, excluding the user's train and valid/test
    positives (dataloader.py:145-151). With an exclusion mass of a few
    percent, P(all 32 collide) < 1e-20.
  * SCHGN's masked-ingredient task (dataloader.py:117-143, utils.py:186-190):
    real ingredient slots masked with probability 0.2, and a negative
    ingredient per masked slot that is not in the recipe.

The packed bitmap is an int32 view of the JAX package's uint32 words
(torch.uint32 has few CUDA ops); `(word >> bit) & 1` reads the same bit
either way.
"""

import torch


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
    do_mask = (torch.rand((b, L), generator=generator, device=dev)
               < masked_p) & real
    masked_seq = torch.where(do_mask, n_ingredients + 1, ingre_codes)

    draws = torch.randint(0, n_ingredients, (n_tries, b, L),
                          generator=generator, device=dev)
    real_codes = torch.where(real, ingre_codes, -1)
    in_recipe = (draws[..., None] == real_codes[None, :, None, :]).any(-1)
    ok = ~in_recipe                                        # [T, B, L]
    first_ok = ok.to(torch.uint8).argmax(dim=0)
    pick = torch.where(ok.any(dim=0), first_ok, n_tries - 1)
    neg_draw = draws.gather(0, pick[None])[0]
    neg_seq = torch.where(do_mask, neg_draw, ingre_codes)
    return masked_seq, ingre_codes, neg_seq
