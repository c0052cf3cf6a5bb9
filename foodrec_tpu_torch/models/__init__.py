# coding: utf-8
"""Model zoo registry, keyed by the config `model` strings."""

import importlib

# the models the port has: all six of the JAX package's
PORTED = ("CIKM_Model", "LightGCN", "BM3", "FGCN", "PRICAI_ModelX", "SCHGN")
_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_model(name):
    # import lazily so `foodrec_tpu_torch.models` stays cheap to import
    if name not in _REGISTRY:
        module = f"foodrec_tpu_torch.models.{name.lower()}"
        try:
            importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:  # a missing dependency, not a missing model
                raise
    if name not in _REGISTRY:
        raise ValueError(f"unknown model: {name} (the port has "
                         f"{', '.join(PORTED)})")
    return _REGISTRY[name]
