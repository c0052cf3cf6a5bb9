# coding: utf-8
"""Carry parameters from the JAX package into the port.

`params_from_jax` takes a CIKM_Model `init_params` pytree of the JAX package
(numpy arrays, e.g. after `jax.device_get`) and returns the port module's
state_dict. The leaf names are the JAX package's, which are also the original
FoodRec names (lockstep_check.py:84-118).
"""

import numpy as np
import torch

# leaves the serving module holds
SERVING_LEAVES = ("user_embedding", "item_embedding", "ingre_embedding")
# leaves that arrive with calculate_loss in the training slice
TRAINING_LEAVES = ("encoder", "mm_target_atten", "ingre_target_atten",
                   "health_mlp", "image_trs", "text_trs", "image_embedding",
                   "text_embedding")


def params_from_jax(params, model):
    """Return (state_dict, unported): the serving leaves as float32 tensors
    on the model's device, and the names of the leaves the port does not hold
    yet. Raises on an unknown leaf, a missing serving leaf or a shape that
    differs from the model's."""
    unknown = sorted(set(params) - set(SERVING_LEAVES) - set(TRAINING_LEAVES))
    if unknown:
        raise KeyError(f"unknown CIKM_Model leaves: {unknown}")
    want = model.state_dict()
    state = {}
    for name in SERVING_LEAVES:
        if name not in params:
            raise KeyError(f"missing CIKM_Model leaf: {name}")
        arr = np.asarray(params[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{tuple(want[name].shape)}")
        state[name] = torch.from_numpy(arr.copy()).to(want[name].device)
    unported = [n for n in TRAINING_LEAVES if n in params]
    return state, unported
