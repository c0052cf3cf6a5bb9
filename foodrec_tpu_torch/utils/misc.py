# coding: utf-8
"""Cross-cutting utilities (copy of `foodrec_tpu/utils/misc.py:32-68`;
reference FoodRec/utils/utils.py)."""

import datetime
import random

import numpy as np


def get_local_time():
    return datetime.datetime.now().strftime("%b-%d-%Y-%H-%M-%S")


def init_seed(seed):
    """Seed the host RNGs (`random`, numpy) as the JAX package does. Device
    randomness comes from explicit `torch.Generator`s seeded from
    config['seed'] (the model's init, the trainer's draws), never from
    torch's global generator."""
    random.seed(seed)
    np.random.seed(seed)


def early_stopping(value, best, cur_step, max_step, bigger=True):
    """Validation-based early stopping with the semantics of
    FoodRec/utils/utils.py:56-97.

    Returns (best, cur_step, stop_flag, update_flag).
    """
    stop_flag = False
    update_flag = False
    better = value > best if bigger else value < best
    if better:
        cur_step = 0
        best = value
        update_flag = True
    else:
        cur_step += 1
        if cur_step > max_step:
            stop_flag = True
    return best, cur_step, stop_flag, update_flag


def dict2str(result_dict):
    """Format a metric dict the way the reference logs it (utils.py:100-113)."""
    return "".join(
        f"{metric}: {value:.04f}    " for metric, value in result_dict.items()
    )
