# coding: utf-8
"""On-device negative sampling for the train epoch (counterpart of
`foodrec_tpu/data/sampling.py`).

Replaces the reference dataloader's host rejection loop (uniform items,
excluding the user's train and valid/test positives, dataloader.py:145-151)
with a fixed number of draws T: the first draw that is not excluded is
taken, and the last draw if all T collide. With an exclusion mass of a few
percent, P(all 32 collide) < 1e-20.

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
