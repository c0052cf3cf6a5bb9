# coding: utf-8
"""Trainer: the training epoch, `fit` and by-user evaluation (counterpart of
`foodrec_tpu/engine/trainer.py:48-160, 164-478, 481-644`; reference
FoodRec/common/trainer.py:87-503).

An epoch runs on the device without host round trips between steps: a
device permutation of the train pairs, cut into `ceil(n_train / bs)` batches
with the last one at its exact size; negatives drawn on the device against
the packed exclusion bitmap (data/sampling.py); one Adam step per batch on
the summed loss parts. Semantics kept from the JAX package:

  * L2 weight decay added into the gradient, then Adam with eps 1e-8
    (torch's `Adam(weight_decay=...)`), and LambdaLR lr0 * s0 ** (epoch / s1)
    stepped once per epoch (trainer.py:48-68, 94-108)
  * optional global-norm clipping, scale = min(1, max / (||g|| + 1e-6))
  * the loss parts summed on the device; the NaN check runs once every
    `epoch_scan_chunk` steps, the JAX package's granularity, and the epoch
    stops there (trainer.py:459-463)
  * eval every `eval_step` epochs, early stopping on `valid_metric` with
    patience `stopping_step`, a host snapshot of the best parameters, and the
    final test on them (trainer.py:588-617)

Random streams come from one `torch.Generator` on the model's device, seeded
from config['seed']: the permutation, the negatives and the dropout masks.
Not ported yet (ROADMAP.md): Mirror Gradient, the cosine probe, row-sparse
Adam, health-stratified negatives, checkpoints and resume, the padded final
batch (`exact_final_batch: False`), learners other than Adam, and the
full-sort and sampled eval paths.
"""

import functools
import logging
import time

import numpy as np
import torch

from foodrec_tpu_torch.data.sampling import sample_negatives
from foodrec_tpu_torch.engine.evaluator import evaluate_by_user
from foodrec_tpu_torch.utils.misc import dict2str, early_stopping


def build_optimizer(learner, params, lr, weight_decay):
    """L2 weight decay in the gradient, then Adam eps 1e-8
    (trainer.py:48-68)."""
    if (learner or "adam").lower() != "adam":
        raise NotImplementedError(
            f"learner {learner!r} is not ported yet; only adam is")
    return torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=weight_decay)


class Trainer:
    def __init__(self, config, model):
        for key in ("health_neg_sample", "calcu_cos_similarity",
                    "resume_from", "save_state_every"):
            if config[key]:
                raise NotImplementedError(
                    f"{key} is not ported yet (ROADMAP.md)")
        if config["exact_final_batch"] is False:
            raise NotImplementedError(
                "the padded final batch (exact_final_batch: False) is not "
                "ported; the last batch runs at its exact size")
        self.config = config
        self.model = model
        self.logger = logging.getLogger()
        self.epochs = config["epochs"]
        self.eval_step = min(config["eval_step"], self.epochs)
        self.stopping_step = config["stopping_step"]
        self.clip_grad_norm = config["clip_grad_norm"]
        self.valid_metric_bigger = config["valid_metric_bigger"]
        self.eval_batch_size = config["eval_batch_size"]
        self.neg_sample_num = config["neg_sample_num"]

        dd = model.dd
        self.train_batch_size = config["train_batch_size"]
        self.n_train = dd.n_train
        self.n_batches = -(-self.n_train // self.train_batch_size)
        self.chunk = min(config["epoch_scan_chunk"] or self.n_batches,
                         self.n_batches)
        self.num_items = dd.num_items  # the sampler's range (trainer.py:194)
        self.n_tries = config["neg_sample_tries"] or 32

        s0, s1 = config["learning_rate_scheduler"] or [1.0, 50]
        self.optimizer = build_optimizer(
            config["learner"], model.parameters(), config["learning_rate"],
            float(config["weight_decay"] or 0.0))
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda epoch: s0 ** (epoch / s1))

        dev = model.device
        self._train_u = torch.as_tensor(dd.train_u).to(dev, torch.int64)
        self._train_i = torch.as_tensor(dd.train_i).to(dev, torch.int64)
        self._excl = torch.from_numpy(dd.excl_bitmap.view(np.int32)).to(dev)
        seed = config["seed"]
        if isinstance(seed, (list, tuple)):
            seed = seed[0]
        self.generator = torch.Generator(device=dev).manual_seed(
            int(seed or 2020))

        self.best_valid_score = -1.0
        self.best_valid_result = None
        self.train_loss_dict = {}

    # ------------------------------------------------------------------ train
    def train_steps(self, batches):
        """One optimizer step per `(u, pos, neg)` batch of int64 id tensors
        on the model's device; returns the loss parts summed over the
        batches, [n_parts] on the device."""
        model, optimizer = self.model, self.optimizer
        total = None
        for u, pos, neg in batches:
            parts = model.calculate_loss(u, pos, neg, generator=self.generator)
            optimizer.zero_grad(set_to_none=True)
            sum(parts).backward()
            if self.clip_grad_norm:
                torch.nn.utils.clip_grad_norm_(
                    model.parameters(),
                    self.clip_grad_norm.get("max_norm", 1.0))
            optimizer.step()
            parts = torch.stack(parts).detach()
            total = parts if total is None else total + parts
        return total

    def _batches(self, perm, first, last):
        """Batches `first` to `last - 1` of the epoch's permutation, with
        negatives drawn on the device as each is needed."""
        bs = self.train_batch_size
        for b in range(first, last):
            idx = perm[b * bs:(b + 1) * bs]  # the last batch at its exact size
            u = self._train_u[idx]
            neg = sample_negatives(u, self._excl, self.num_items,
                                   self.generator, n_tries=self.n_tries)
            yield u, self._train_i[idx], neg

    def train_epoch(self):
        """One pass over the train pairs in a fresh device permutation;
        returns the summed loss parts on the device. A non-finite chunk of
        `epoch_scan_chunk` steps ends the epoch early."""
        perm = torch.randperm(self.n_train, generator=self.generator,
                              device=self.model.device)
        loss_parts = None
        for first in range(0, self.n_batches, self.chunk):
            parts = self.train_steps(self._batches(
                perm, first, min(first + self.chunk, self.n_batches)))
            loss_parts = parts if loss_parts is None else loss_parts + parts
            if self.chunk < self.n_batches and not torch.isfinite(parts).all():
                break
        return loss_parts

    # ------------------------------------------------------------------- fit
    def fit(self, dataset, valid_data=None, test_data=None):
        """Train for config['epochs'] epochs (fewer on early stop or a NaN
        loss), evaluating every `eval_step`; returns (best valid score, best
        valid metrics, test metrics of the best parameters), and leaves the
        best parameters in the model. The eval sets default to
        `dataset.device_data`'s."""
        dd = dataset.device_data
        valid_data = dd.eval_valid if valid_data is None else valid_data
        test_data = dd.eval_test if test_data is None else test_data
        best_state = self._host_snapshot()
        cur_step = 0

        for epoch_idx in range(self.epochs):
            t0 = time.time()
            loss_parts = self.train_epoch().cpu().numpy()
            if not np.isfinite(loss_parts).all():
                self.logger.info(f"Loss is nan at epoch: {epoch_idx}. Exiting.")
                break
            self.train_loss_dict[epoch_idx] = float(loss_parts.sum())
            lr_now = self.scheduler.get_last_lr()[0]
            parts_str = ", ".join(
                f"train_loss{i + 1}: {v / self.n_batches:.4f}"
                for i, v in enumerate(loss_parts))
            self.logger.info(
                f"epoch {epoch_idx} training [time: {time.time() - t0:.2f}s, "
                f"lr: {lr_now:.6f}, {parts_str}]")
            self.scheduler.step()

            if (epoch_idx + 1) % self.eval_step == 0:
                t_eval = time.time()
                valid_score, valid_result = self._valid(valid_data)
                (self.best_valid_score, cur_step, stop_flag,
                 update_flag) = early_stopping(
                    valid_score, self.best_valid_score, cur_step,
                    max_step=self.stopping_step,
                    bigger=self.valid_metric_bigger)
                self.logger.info(
                    f"epoch {epoch_idx} evaluating [time: "
                    f"{time.time() - t_eval:.2f}s, valid_score: "
                    f"{valid_score:.6f}]")
                self.logger.info(f"valid result: \n{dict2str(valid_result)}")
                if update_flag:
                    self.best_valid_result = valid_result
                    best_state = self._host_snapshot()
                if stop_flag:
                    self.logger.info(
                        f"+++++Finished training, best eval result in epoch "
                        f"{epoch_idx - cur_step * self.eval_step}")
                    break

        # the final test on the best-on-valid parameters (trainer.py:614-617)
        self.model.load_state_dict(best_state)
        _, best_test_upon_valid = self._valid(test_data, is_test=True)
        return (self.best_valid_score, self.best_valid_result,
                best_test_upon_valid)

    def _host_snapshot(self):
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    # ------------------------------------------------------------------ eval
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
