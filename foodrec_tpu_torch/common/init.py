# coding: utf-8
"""Parameter initializers with torch fan semantics (counterpart of
`foodrec_tpu/common/init.py`).

torch's xavier_* on an Embedding(num, dim) treats the table as a [num, dim]
linear weight: fan_in = dim, fan_out = num. Values are drawn on the CPU from
an explicit `torch.Generator`, so one seed gives the same tables on any
device.
"""

import math

import torch


def _torch_fans(shape):
    """torch.nn.init._calculate_fan_in_and_fan_out for a weight [out, in, ...]."""
    if len(shape) == 2:
        return shape[1], shape[0]
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def xavier_uniform(shape, generator, gain=1.0):
    """U(-b, b) with b = gain * sqrt(6 / (fan_in + fan_out)), float32 on the CPU."""
    fan_in, fan_out = _torch_fans(shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)
