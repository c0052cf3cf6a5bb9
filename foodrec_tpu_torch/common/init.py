# coding: utf-8
"""Parameter initializers with torch fan semantics, and the linear layer
(counterpart of `foodrec_tpu/common/init.py`).

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


def xavier_normal(shape, generator, gain=1.0):
    """N(0, std) with std = gain * sqrt(2 / (fan_in + fan_out)), float32 on
    the CPU."""
    fan_in, fan_out = _torch_fans(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, dtype=torch.float32, generator=generator)


def truncated_normal(shape, generator, mean=0.0, std=1.0):
    """mean + std * N(0, 1) truncated at +-2 (not rescaled to unit
    variance), float32 on the CPU: SCHGN's init (schgn.py:18-26)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return mean + std * t


def tn_linear(d_in, d_out, generator, w_std, b_std=None, bias=True):
    """SCHGN's re-initialized Linear (schgn.py:130-138): a truncated-normal
    weight of std `w_std`, drawn [out, in] and stored [in, out], and a
    truncated-normal bias of std `b_std` (default `w_std`)."""
    p = {"w": truncated_normal((d_out, d_in), generator,
                               std=w_std).T.contiguous()}
    if bias:
        p["b"] = truncated_normal((d_out,), generator, std=b_std or w_std)
    return p


def linear_params(d_in, d_out, generator, init=xavier_normal):
    """A {'w': [in, out], 'b': [out]} linear layer with a zero bias (the
    reference's xavier initializers, init.py:7-42). The weight is stored
    [in, out] as the JAX package stores it; the initializer sees torch's
    [out, in] fans."""
    return {"w": init((d_out, d_in), generator).T.contiguous(),
            "b": torch.zeros(d_out)}


def torch_linear(d_in, d_out, generator, init=xavier_normal):
    """nn.Linear(d_in, d_out) with its weight re-drawn by `init` and torch's
    own bias init U(-1/sqrt(d_in), 1/sqrt(d_in)) (cikm_model.py:70-75)."""
    w = init((d_out, d_in), generator).T.contiguous()
    bound = 1.0 / math.sqrt(d_in)
    b = torch.empty(d_out).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def default_linear(d_in, d_out, generator):
    """nn.Linear(d_in, d_out) as torch initializes it: weight and bias both
    U(-1/sqrt(d_in), 1/sqrt(d_in)) (kaiming_uniform with a = sqrt(5)); the
    weight is drawn [in, out], as the JAX package draws it."""
    bound = 1.0 / math.sqrt(d_in)
    w = torch.empty(d_in, d_out).uniform_(-bound, bound, generator=generator)
    b = torch.empty(d_out).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def linear_apply(p, x):
    return x @ p["w"] + p["b"]
