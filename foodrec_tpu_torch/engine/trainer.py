# coding: utf-8
"""Trainer, evaluation half (counterpart of `foodrec_tpu/engine/trainer.py:71-160,
620-644, 732-733`; reference FoodRec/common/trainer.py:231-282, 428-437).

`evaluate` runs the reference's default by-user eval: the model's graph
propagation once (`eval_cache`), then candidate scoring and metrics per user
block. `fit` and the training epoch arrive with the training slice; the
full-sort and sampled eval paths are still to port (ROADMAP.md).
"""

import functools

import torch

from foodrec_tpu_torch.engine.evaluator import evaluate_by_user


class Trainer:
    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.eval_batch_size = config["eval_batch_size"]
        self.neg_sample_num = config["neg_sample_num"]

    @torch.no_grad()
    def _valid(self, eval_set, is_test=False):
        """Dispatch between the reference's three eval paths
        (trainer.py:428-437): eval_by_user (default) > full_sort > sampled."""
        if self.config["eval_by_user"]:
            return self._valid_by_user(eval_set)
        if self.config["full_sort"]:
            raise NotImplementedError(
                "full_sort eval is not ported yet (ROADMAP: evaluation "
                "breadth, TopKEvaluator)")
        raise NotImplementedError(
            "sampled-rank eval is not ported yet (ROADMAP: evaluation "
            "breadth, sample_rank_metrics)")

    def _valid_by_user(self, eval_set):
        model = self.model
        cache = model.eval_cache()  # graph propagation once per eval
        bs = self.eval_batch_size
        cap = getattr(model, "eval_batch_cap", None)
        if cap:
            bs = min(bs, cap)
        return evaluate_by_user(
            functools.partial(model.score_from_cache, cache), eval_set,
            self.neg_sample_num, batch_size=bs, device=model.device)

    def evaluate(self, eval_set, is_test=False):
        return self._valid(eval_set, is_test)[1]
