# coding: utf-8
"""Checkpoints (counterpart of `foodrec_tpu/engine/checkpoint.py:39-104`;
SURVEY.md §5.4).

The reference only torch.save()s the best-on-valid state_dict and reloads it
for the final test (FoodRec/common/trainer.py:390-396, 449-450, 463). Here,
as in the JAX package:

  * `save_best` / `load_best`: the best-on-valid parameters, a host
    state_dict
  * `save_state` / `load_state`: everything a resumed `fit` needs to go on
    as if it had not stopped: the model, optimizer and lr-schedule states,
    the trainer's generator state, the epoch, the early-stopping counters
    and the loss log

Both are `torch.save` files, read back with `weights_only=True` (no code
runs on load), where the JAX package uses pickle and orbax.
"""

import torch


def _to_host(state_dict):
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


def save_best(state_dict, path):
    """The model's parameters, on the host."""
    torch.save(_to_host(state_dict), path)


def load_best(path):
    """The state_dict `save_best` wrote, on the host."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state(path, model_state, optimizer_state, schedule_state,
               generator_state, epoch, best_valid_score, cur_step,
               train_loss_dict):
    """The full resumable training state after epoch `epoch`."""
    torch.save({
        "model": _to_host(model_state),
        "optimizer": optimizer_state,
        "schedule": schedule_state,
        "generator": generator_state.cpu(),
        "epoch": int(epoch),
        "best_valid_score": float(best_valid_score),
        "cur_step": int(cur_step),
        "train_loss_dict": {int(k): float(v)
                            for k, v in train_loss_dict.items()},
    }, path)


def load_state(path):
    """The dict `save_state` wrote, tensors on the host (the caller's
    `load_state_dict`s move them to the model's device)."""
    return torch.load(path, map_location="cpu", weights_only=True)
