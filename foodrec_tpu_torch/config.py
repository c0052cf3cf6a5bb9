# coding: utf-8
"""Layered yaml configuration (copy of `foodrec_tpu/config.py` without JAX).

Reproduces the reference semantics (FoodRec/utils/configurator.py:11-139):

  * merge order: overall.yaml -> dataset/{dataset}.yaml (optional) ->
    model/{model}.yaml -> mg.yaml (if mg) -> runtime dict (highest priority)
  * `hyper_parameters` lists from every file are concatenated, and 'seed' is
    force-included (configurator.py:106-108)
  * a custom yaml float resolver so `1e-4` parses as float
    (configurator.py:88-100)
  * missing keys read as None (configurator.py:121-125)
  * `valid_metric_bigger` derived from the metric name (configurator.py:102-105)

config['device'] is "cuda" when `use_gpu` is true (the default) and "cpu"
when the caller passes `use_gpu: False`; asking for CUDA where there is none
raises (utils/device.py).
"""

import os
import re

import yaml

from foodrec_tpu_torch.utils.device import resolve_device

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

_SMALLER_METRICS = ("rmse", "mae", "logloss")


def _yaml_loader():
    """yaml loader whose float resolver accepts scientific notation like 1e-4
    (the default yaml 1.1 resolver parses `1e-4` as a string)."""
    loader = yaml.FullLoader
    loader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:
             [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return loader


class Config:
    """Dict-like layered config; missing keys return None."""

    def __init__(self, model=None, dataset=None, config_dict=None, mg=False):
        config_dict = dict(config_dict or {})
        config_dict["model"] = model
        config_dict["dataset"] = dataset

        self.final_config_dict = self._load_file_configs(config_dict, mg)
        # runtime dict has the highest priority (configurator.py:58-60)
        self.final_config_dict.update(config_dict)
        self._set_default_parameters()
        use_gpu = self.final_config_dict.get("use_gpu", True)
        self.final_config_dict["device"] = str(
            resolve_device("cuda" if use_gpu else "cpu"))

    def _load_file_configs(self, config_dict, mg):
        merged = {}
        files = [
            os.path.join(_CONFIG_DIR, "overall.yaml"),
            os.path.join(_CONFIG_DIR, "dataset", f"{config_dict['dataset']}.yaml"),
            os.path.join(_CONFIG_DIR, "model", f"{config_dict['model']}.yaml"),
        ]
        if mg:
            files.append(os.path.join(_CONFIG_DIR, "mg.yaml"))
        hyper_parameters = []
        loader = _yaml_loader()
        for path in files:
            if not os.path.isfile(path):
                continue
            with open(path, "r", encoding="utf-8") as f:
                data = yaml.load(f.read(), Loader=loader)
            if not data:
                continue
            if data.get("hyper_parameters"):
                hyper_parameters.extend(data["hyper_parameters"])
            merged.update(data)
        merged["hyper_parameters"] = hyper_parameters
        return merged

    def _set_default_parameters(self):
        valid_metric = self.final_config_dict["valid_metric"].split("@")[0]
        self.final_config_dict["valid_metric_bigger"] = (
            valid_metric.lower() not in _SMALLER_METRICS
        )
        if "seed" not in self.final_config_dict["hyper_parameters"]:
            self.final_config_dict["hyper_parameters"] += ["seed"]

    # -- dict-style access ---------------------------------------------------
    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        self.final_config_dict[key] = value

    def __getitem__(self, item):
        return self.final_config_dict.get(item)

    def __contains__(self, key):
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        return key in self.final_config_dict

    def __str__(self):
        body = "\n".join(
            f"{k}={v}" for k, v in self.final_config_dict.items()
        )
        return "\n" + body + "\n\n"

    def __repr__(self):
        return self.__str__()


def hyper_combinations(config):
    """Expand config['hyper_parameters'] into the grid-search cartesian product
    (copy of `foodrec_tpu/config.py:144-165`; FoodRec/utils/quick_start.py:
    54-60): each hyper_parameters entry names a config key whose value is a
    list of candidates; keys whose value is falsy expand to [None]."""
    from itertools import product

    names = list(config["hyper_parameters"])
    if "seed" not in names:
        names = ["seed"] + names
    grids = []
    for name in names:
        val = config[name]
        if not val:
            grids.append([None])
        elif isinstance(val, (list, tuple)):
            grids.append(list(val))
        else:
            grids.append([val])
    return names, list(product(*grids))
