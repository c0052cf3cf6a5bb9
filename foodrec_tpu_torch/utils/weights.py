# coding: utf-8
"""Carry parameters from the JAX package into the port.

`params_from_jax` takes an `init_params` pytree of any model of the JAX
package that the port has (numpy arrays, e.g. after `jax.device_get`) and
returns the port module's state_dict. The port names its parameters like
the pytree, so a leaf at `params["encoder"][1]["ff1_w"]` is
`encoder.1.ff1_w` in the port and `params["ir_aggs"][0]["W1"]["w"]` is
`ir_aggs.0.W1.w`, with the same [in, out] layout; an `mlp_layers_params`
list is `0.w`, `0.b`, `1.w`, ... either way. The variants map the same
way: with `freeze_modality_tables` the image and text tables are buffers
outside the state_dict, as they are outside the JAX pytree, and CIKM_Model's
health head has the scalar level's width where the config asks for it.
"""

import numpy as np
import torch


def flatten_params(tree, prefix=""):
    """{dotted name: leaf} of a nested dict/list pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(params, model):
    """The model's state_dict filled from the pytree `params`: every leaf,
    in the model parameter's dtype and on its device. Raises on an unknown
    leaf, a missing leaf or a shape that differs from the model's."""
    flat = flatten_params(params)
    want = model.state_dict()
    name = type(model).__name__
    unknown = sorted(set(flat) - set(want))
    if unknown:
        raise KeyError(f"unknown {name} leaves: {unknown}")
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"missing {name} leaves: {missing}")
    state = {}
    for key, ref in want.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {arr.shape} != port shape "
                             f"{tuple(ref.shape)}")
        state[key] = torch.from_numpy(arr.copy()).to(device=ref.device,
                                                      dtype=ref.dtype)
    return state
