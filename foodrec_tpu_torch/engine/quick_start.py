# coding: utf-8
"""Experiment driver: config -> data -> grid search -> leaderboard
(counterpart of `foodrec_tpu/engine/quick_start.py:23-103`; reference
FoodRec/utils/quick_start.py:17-106).

The dataset is read and its device arrays built once, for every combination
of the grid; each combination seeds the host RNGs, builds its model from a
generator seeded with its `seed`, and fits a fresh trainer.
"""

import logging
import platform
from itertools import product

import torch

from foodrec_tpu_torch.config import Config
from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
from foodrec_tpu_torch.data.device import DeviceData
from foodrec_tpu_torch.engine.trainer import get_trainer
from foodrec_tpu_torch.models import get_model
from foodrec_tpu_torch.utils.logger import init_logger
from foodrec_tpu_torch.utils.misc import dict2str, init_seed


def quick_start(model=None, dataset=None, config_dict=None, save_model=True,
                mg=False):
    """Run the grid over config['hyper_parameters'] and return the
    combination whose test score on `valid_metric` is best, as
    (hyper_tuple, best valid metrics, test metrics). On the card unless
    `config_dict` holds `use_gpu: False`."""
    config = Config(model, dataset, config_dict, mg)
    derive_data_paths(config, dataset)
    init_logger(config)
    logger = logging.getLogger()

    logger.info("██Server: \t" + platform.node())
    logger.info("██Dir: \t" + str(config["data_path"]))
    logger.info("\n" + str(config))

    food_data = FoodData(config)
    logger.info(str(food_data))
    food_data.device_data = DeviceData.from_food_data(food_data)

    # grid search over hyper_parameters (quick_start.py:54-65)
    hyper_ls = []
    if "seed" not in config["hyper_parameters"]:
        config["hyper_parameters"] = ["seed"] + config["hyper_parameters"]
    for i in config["hyper_parameters"]:
        hyper_ls.append(config[i] if config[i] is not None else [None])
    hyper_ls = [v if isinstance(v, (list, tuple)) else [v] for v in hyper_ls]
    combinators = list(product(*hyper_ls))
    total_loops = len(combinators)

    hyper_ret = []
    val_metric = config["valid_metric"].lower()
    best_test_value = 0.0
    idx = best_test_idx = 0

    logger.info("\n\n=================================\n\n")
    for hyper_tuple in combinators:
        for j, k in zip(config["hyper_parameters"], hyper_tuple):
            config[j] = k
        init_seed(config["seed"])

        logger.info("========={}/{}: Parameters:{}={}======="
                    .format(idx + 1, total_loops,
                            config["hyper_parameters"], hyper_tuple))

        generator = torch.Generator().manual_seed(int(config["seed"] or 2020))
        model_obj = get_model(config["model"])(config, food_data, generator)
        trainer = get_trainer()(config, model_obj, mg)
        best_valid_score, best_valid_result, best_test_upon_valid = (
            trainer.fit(food_data, saved=save_model, hyper_tuple=hyper_tuple))
        hyper_ret.append((hyper_tuple, best_valid_result, best_test_upon_valid))

        if best_test_upon_valid.get(_canon(val_metric, best_test_upon_valid),
                                    0.0) > best_test_value:
            best_test_value = best_test_upon_valid[
                _canon(val_metric, best_test_upon_valid)]
            best_test_idx = idx
        idx += 1

        logger.info("best valid result: {}".format(dict2str(best_valid_result or {})))
        logger.info("test result: {}".format(dict2str(best_test_upon_valid)))
        logger.info("████Current BEST████:\nParameters: {}={},\n"
                    "Valid: {},\nTest: {}\n\n\n".format(
                        config["hyper_parameters"],
                        hyper_ret[best_test_idx][0],
                        dict2str(hyper_ret[best_test_idx][1] or {}),
                        dict2str(hyper_ret[best_test_idx][2])))

    logger.info("\n============All Over=====================")
    for p, k, v in hyper_ret:
        logger.info("Parameters: {}={},\nbest valid: {},\nbest test: {}".format(
            config["hyper_parameters"], p, dict2str(k or {}), dict2str(v)))

    logger.info("\n\n█████████████ BEST ████████████████")
    logger.info("\tParameters: {}={},\nValid: {},\nTest: {}\n\n".format(
        config["hyper_parameters"], hyper_ret[best_test_idx][0],
        dict2str(hyper_ret[best_test_idx][1] or {}),
        dict2str(hyper_ret[best_test_idx][2])))
    return hyper_ret[best_test_idx]


def _canon(metric_lower, result_dict):
    """Map a lowered metric name like 'ndcg@20' onto the dict's actual key."""
    for k in result_dict:
        if k.lower() == metric_lower:
            return k
    return metric_lower
