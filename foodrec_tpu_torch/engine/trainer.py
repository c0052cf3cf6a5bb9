# coding: utf-8
"""Trainer: the training epoch, Mirror Gradient, `fit` with checkpoints and
resume, and the by-user, full-sort, sampled and study evaluations
(counterpart of `foodrec_tpu/engine/trainer.py`; reference
FoodRec/common/trainer.py:87-503, 631-804).

An epoch runs on the device without host round trips between steps: a
device permutation of the train pairs, cut into `ceil(n_train / bs)` batches
with the last one at its exact size (or, with `exact_final_batch: False`,
the permutation resized cyclically to full batches and the wrapped rows
weighted 0); negatives drawn on the device against the packed exclusion
bitmap (data/sampling.py), and a health-stratified second negative with
`health_neg_sample`; one optimizer step per batch on the summed loss parts.
Semantics kept from the JAX package:

  * the optimizer chain of trainer.py:48-68: L2 weight decay added into the
    gradient, then Adam (eps 1e-8, torch's `Adam(weight_decay=...)`), SGD,
    or optax's Adagrad (`scale_by_rss`) or RMSprop (`scale_by_rms`, decay
    0.99), written out below; an unknown name warns and takes Adam
  * the learning rate lr0 * s0 ** ((count // n_batches) / s1) of optax's
    update count (trainer.py:94-108): the JAX package's quirk, kept. Without
    Mirror Gradient that is LambdaLR's lr0 * s0 ** (epoch / s1) stepped once
    per epoch, which `scheduler` holds for the log; Mirror Gradient's second
    update advances the count, so its lr reaches the next epoch's value
    before the epoch ends (the reference steps LambdaLR per epoch instead)
  * optional global-norm clipping, scale = min(1, max / (||g|| + 1e-6)),
    on each update
  * Mirror Gradient (`mg=True`, trainer.py:306-322): on every batch whose
    index in the epoch is a multiple of `beta`, a step on alpha1 * g, the
    batch replayed at the new parameters with the same dropout draws, and a
    step on -alpha2 * g2
  * `row_sparse_table_update` is accepted and every update is the dense
    one: the JAX package's row-sparse Adam (trainer.py:215-240) gives the
    dense update's results bit for bit, and on the H100 a row-sparse
    update of CIKM_Model's modality tables took more device time than the
    dense one (PERF.md §7); `True` says so in the log
  * the cosine probe (`calcu_cos_similarity`, utils/diagnostics.py) summed
    over the epoch and logged; a model without same-width id, text and
    image tables (the six shipped ones) gives zeros, as in JAX
  * the loss parts summed on the device; the NaN check runs once every
    `epoch_scan_chunk` steps, the JAX package's granularity, and the epoch
    stops there (trainer.py:459-463)
  * `req_training: False` evaluates the initial parameters without
    training (trainer.py:538-540)
  * eval every `eval_step` epochs, early stopping on `valid_metric` with
    patience `stopping_step`, a host snapshot of the best parameters (saved
    under `ckp_root` with `saved=True`), and the final test on them
    (trainer.py:588-617); `save_state_every` / `resume_from` for a run that
    stops and goes on (trainer.py:513-530, 574-586)
  * `profile_trace_dir`: epoch 1 (the second) under torch.profiler, its
    trace written there (trainer.py:534-547). The trace holds the port's
    spans (utils/trace.py): `foodrec::train_step` for each batch, and
    inside it `sampler`, `forward` (with each `spmm_forward`), `backward`
    and `optimizer`; untraced epochs pay one flag check a span

Random streams come from one `torch.Generator` on the model's device, seeded
from config['seed']: the permutation, the negatives and the dropout masks.

`mesh_shape` (trainer.py:110-113, 282-285, 501-506, 663-684) runs the
trainer on every rank of a mesh (parallel/mesh.py), with the semantics of
the JAX package's mesh: a sharded run computes what one process computes.
Every rank draws the global batch, its permutation, negatives and dropout
masks from the same generator; `data` ranks take their rows of each batch
that divides the axis (a tail that does not runs whole on each); the loss
parts are the global batch's on every rank, each rank backpropagates 1/size
of them, and the gradients are summed over `data` with one all_reduce after
each backward (both of Mirror Gradient's), so that the optimizer, local to
each rank, takes the single-process step. The modality tables that
`param_shardings` picks hold only their rows on each `model` rank, with
their optimizer state; the replicated leaves take the first `model` rank's
gradient, so that their copies cannot part. Checkpoints hold the tables
whole and are written by rank 0; a mesh checkpoint loads into one process
and the other way round. The evaluations are replicated, as in the JAX
package, except the full-sort top-k, which a `model` axis splits by item
(`distributed_full_sort_topk`); every rank takes rank 0's metrics, so that
early stopping agrees.
"""

import functools
import logging
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from foodrec_tpu_torch.data.device import build_eval_set
from foodrec_tpu_torch.data.sampling import (
    sample_health_stratified_negatives,
    sample_negatives,
)
from foodrec_tpu_torch.engine import checkpoint as ckpt
from foodrec_tpu_torch.engine.evaluator import evaluate_by_user
from foodrec_tpu_torch.engine.topk_evaluator import (
    TopKEvaluator,
    distributed_full_sort_topk,
    full_sort_topk,
    sample_rank_metrics,
)
from foodrec_tpu_torch.models.base import GeneralRecommender
from foodrec_tpu_torch.parallel import collectives as coll
from foodrec_tpu_torch.parallel.mesh import batch_rows, make_mesh, shard_batch
from foodrec_tpu_torch.utils.diagnostics import embedding_cos_similarity
from foodrec_tpu_torch.utils.misc import dict2str, early_stopping
from foodrec_tpu_torch.utils.trace import span


def _decayed(p, g, weight_decay):
    """optax.add_decayed_weights: g + weight_decay * p."""
    return g + weight_decay * p if weight_decay else g


class Adagrad(torch.optim.Optimizer):
    """optax's `scale_by_rss(initial_accumulator_value=0, eps=1e-10)` after
    the decay: s = g^2 + s, then p -= lr * g * rsqrt(s + eps), with 0 where
    s = 0 (torch.optim.Adagrad divides by sqrt(s) + eps instead)."""

    def __init__(self, params, lr, weight_decay=0.0, eps=1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = _decayed(p, p.grad, group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.zeros_like(p)
                s = state["sum_of_squares"]
                s.copy_(g * g + s)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.add_(-group["lr"] * (scale * g))


class RMSprop(torch.optim.Optimizer):
    """optax's `scale_by_rms(decay=0.99, eps=1e-8)` after the decay:
    nu = (1 - decay) g^2 + decay nu from nu = 0, then p -= lr * g *
    rsqrt(nu + eps) (torch.optim.RMSprop divides by sqrt(nu) + eps)."""

    def __init__(self, params, lr, weight_decay=0.0, decay=0.99, eps=1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = _decayed(p, p.grad, group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * g ** 2 + decay * nu)
                p.add_(-group["lr"] * (torch.rsqrt(nu + group["eps"]) * g))


def build_optimizer(learner, params, lr, weight_decay):
    """The JAX package's chain (trainer.py:48-68): L2 weight decay in the
    gradient, then the learner's rule, at lr (set before each update)."""
    learner = (learner or "adam").lower()
    if learner == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
    if learner == "adagrad":
        return Adagrad(params, lr, weight_decay)
    if learner == "rmsprop":
        return RMSprop(params, lr, weight_decay)
    if learner != "adam":
        logging.getLogger().warning(
            "Received unrecognized optimizer, set default Adam optimizer")
    return torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=weight_decay)


class Trainer:
    def __init__(self, config, model, mg=False):
        # the mesh first: a size that differs from the process group's
        # raises before anything is built
        self.mesh = make_mesh(config["mesh_shape"], model.device)
        if self.mesh is not None and self.mesh.size("model") > 1:
            model.shard_tables(self.mesh)
        # rank 0 writes the logs' files, checkpoints and top-k lists
        self.writer = self.mesh is None or self.mesh.rank == 0
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
        self.req_training = config["req_training"]
        self.mg = mg
        self.alpha1 = config["alpha1"]
        self.alpha2 = config["alpha2"]
        self.beta = config["beta"]

        dd = model.dd
        self.train_batch_size = config["train_batch_size"]
        self.n_train = dd.n_train
        self.n_batches = -(-self.n_train // self.train_batch_size)
        # the tail at its exact size unless exact_final_batch is False
        # (trainer.py:259-261)
        exact = config["exact_final_batch"]
        self.pad_tail = not (exact or exact is None)
        self.chunk = min(config["epoch_scan_chunk"] or self.n_batches,
                         self.n_batches)
        self.num_items = dd.num_items  # the sampler's range (trainer.py:194)
        self.n_tries = config["neg_sample_tries"] or 32

        s0, s1 = config["learning_rate_scheduler"] or [1.0, 50]
        lr0, n_batches = config["learning_rate"], self.n_batches

        def lr_schedule(count):
            return lr0 * s0 ** ((count // n_batches) / s1)

        self.lr_schedule = lr_schedule
        self.n_updates = 0  # optax's update count, which the lr reads
        self.epoch_batch = 0  # the index in the epoch of the next batch
        weight_decay = float(config["weight_decay"] or 0.0)
        self.optimizer = build_optimizer(
            config["learner"], model.parameters(), lr0, weight_decay)
        # the epoch's lr, logged as the JAX package logs
        # lr_schedule(epoch * n_batches)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda epoch: s0 ** (epoch / s1))

        # the cosine probe, summed over the epoch (trainer.py:212-214)
        self.probe_on = bool(config["calcu_cos_similarity"])
        self._epoch_cos_sim = None
        if config["row_sparse_table_update"] is True:
            self.logger.info(
                "row_sparse_table_update: the dense Adam update runs (the "
                "same results; row-sparse was slower on the H100)")

        dev = model.device
        self._train_u = torch.as_tensor(dd.train_u).to(dev, torch.int64)
        self._train_i = torch.as_tensor(dd.train_i).to(dev, torch.int64)
        self._excl = torch.from_numpy(dd.excl_bitmap.view(np.int32)).to(dev)
        # health-stratified second negatives (trainer.py:196-209)
        self.hns = bool(config["health_neg_sample"])
        if self.hns:
            if dd.health_bucket_items is None:
                raise ValueError(
                    "health_neg_sample set but DeviceData has no bucket arrays")
            self._health = tuple(
                torch.as_tensor(a).to(dev) for a in (
                    dd.health_level, dd.health_bucket_items,
                    dd.health_in_sample, dd.train_items_arr))
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
        """One optimizer step per batch, two for a Mirror Gradient batch.
        A batch is `(u, pos, neg)`, int64 id tensors on the model's device,
        or `(u, pos, neg, extra)` with `extra` a dict that may hold the
        sample `weight` [B] (the padded final batch) and `health_neg`.
        Returns the loss parts summed over the batches (a Mirror Gradient
        batch's first pass), [n_parts] on the device.

        Under a mesh every rank passes the same global batches; each
        takes its rows of them (`_backward`).

        `beta` counts a batch's index in the epoch, `epoch_batch`: the
        batches stepped since `train_epoch` began the epoch, modulo
        n_batches, so that whole epochs passed through here one after
        another (the lockstep tests' replays) index alike."""
        total = None
        for u, pos, neg, *extra in batches:
            weight = extra[0].get("weight") if extra else None
            if self.mg and self.epoch_batch % self.beta == 0:
                parts, g_probe = self._mirror_step(u, pos, neg, weight)
            else:
                parts = self._backward(u, pos, neg, weight)
                g_probe = self._probe_grads()
                self._update()
            if self.probe_on:
                self._probe(g_probe)
            self.epoch_batch = (self.epoch_batch + 1) % self.n_batches
            total = parts if total is None else total + parts
        return total

    def _backward(self, u, pos, neg, weight=None):
        """The loss parts of one batch, their sum's gradient left in .grad.
        Under a mesh the batch is the global one: this rank takes its rows
        (shard_batch), and the gradient is the global batch's."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            with span("forward"):
                parts = self.model.calculate_loss(
                    u, pos, neg, generator=self.generator, weight=weight)
            with span("backward"):
                sum(parts).backward()
            return torch.stack(parts).detach()
        d = self.mesh.size("data")
        b = shard_batch(self.mesh, {"u": u, "pos": pos, "neg": neg,
                                    "weight": weight})
        with batch_rows(self.mesh, u.shape[0]):
            with span("forward"):
                parts = self.model.calculate_loss(
                    b["u"], b["pos"], b["neg"], generator=self.generator,
                    weight=b["weight"])
            with span("backward"):
                loss = sum(parts)
                (loss / d if d > 1 else loss).backward()
                self._reduce_grads()
        return torch.stack(parts).detach()

    def _reduce_grads(self):
        """Sum the gradients over `data` (one all_reduce of every leaf that
        has a gradient on some rank; a leaf with none on any rank keeps
        None, as in one process); then the replicated leaves take the first
        `model` rank's gradient."""
        mesh = self.mesh
        named = list(self.model.named_parameters())
        if mesh.size("data") > 1:
            group = mesh.group("data")
            has = coll.all_reduce(torch.tensor(
                [p.grad is not None for _, p in named], dtype=torch.int32,
                device=self.model.device), group).tolist()
            live = [p for (_, p), h in zip(named, has) if h]
            for p in live:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _flat_collective(live, lambda f: coll.all_reduce(f, group))
        if mesh.size("model") > 1:
            group = mesh.group("model")
            rep = [p for n, p in named
                   if n not in self.model.row_shards and p.grad is not None]
            _flat_collective(rep, lambda f: coll.broadcast(f, group))

    def _set_lr(self):
        lr = self.lr_schedule(self.n_updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _update(self, scale=None):
        """One optimizer step on the gradients times `scale`, clipped, at
        the lr of the update count."""
        with span("optimizer"):
            if scale is not None:
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(scale)
            if self.clip_grad_norm:
                max_norm = self.clip_grad_norm.get("max_norm", 1.0)
                if self.model.row_shards:
                    self._clip_sharded(max_norm)
                else:
                    torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                                   max_norm)
            self._set_lr()
            self.optimizer.step()
        self.n_updates += 1

    @torch.no_grad()
    def _clip_sharded(self, max_norm):
        """clip_grad_norm_ over the whole model when tables are row-sharded:
        their squares summed over `model`."""
        dtype = next(self.model.parameters()).dtype
        sq = [torch.zeros((), dtype=dtype, device=self.model.device)
              for _ in range(2)]
        for n, p in self.model.named_parameters():
            if p.grad is not None:
                sq[n in self.model.row_shards] += (p.grad ** 2).sum()
        coll.all_reduce(sq[1], self.mesh.group("model"))
        total = torch.sqrt(sq[0] + sq[1])
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.mul_(coef.to(p.grad.dtype))

    def _mirror_step(self, u, pos, neg, weight=None):
        """Mirror Gradient on one batch: a step on alpha1 * g, then the batch
        again at the new parameters, the generator restored so that it draws
        the same dropout masks (the JAX package replays the same key), and a
        step on -alpha2 * g2. Returns the first pass's loss parts and its
        probe gradients."""
        state = self.generator.get_state()
        parts = self._backward(u, pos, neg, weight)
        g_probe = self._probe_grads()
        self._update(self.alpha1)
        self.generator.set_state(state)
        self._backward(u, pos, neg, weight)
        self._update(-self.alpha2)
        return parts, g_probe

    def _probe_grads(self):
        """The probe's (id, text, image) gradients, copied before the
        update; None when the probe is off or the model has no such
        tables."""
        if not self.probe_on:
            return None
        g = self.model.diagnostic_embeddings(
            {n: p.grad for n, p in self.model.named_parameters()})
        return None if g is None else tuple(t.detach().clone() for t in g)

    def _probe(self, g_probe):
        """Add this step's six cosine numbers (of the updated tables and the
        step's gradients) to the epoch's sum; zeros without the tables."""
        emb = self.model.diagnostic_embeddings(
            {n: p.detach() for n, p in self.model.named_parameters()})
        if emb is None or g_probe is None:
            sim = torch.zeros(6, device=self.model.device)
        else:
            sim = torch.stack(embedding_cos_similarity(*emb, *g_probe))
        self._epoch_cos_sim = (sim if self._epoch_cos_sim is None
                               else self._epoch_cos_sim + sim)

    def _epoch_perm(self):
        """The epoch's permutation of the train pairs; with the padded tail,
        resized cyclically to n_batches * bs, as `jnp.resize` does
        (trainer.py:343-350)."""
        perm = torch.randperm(self.n_train, generator=self.generator,
                              device=self.model.device)
        if self.pad_tail:
            total = self.n_batches * self.train_batch_size
            perm = perm.repeat(-(-total // self.n_train))[:total]
        return perm

    def _batches(self, perm, first, last):
        """Batches `first` to `last - 1` of the epoch's permutation, with
        negatives (and health negatives) drawn on the device as each is
        needed. With the padded tail every batch has the full size and the
        weight (position < n_train) (trainer.py:264-281)."""
        for b in range(first, last):
            # the step's span stays open while the caller runs the step on
            # this batch, and closes when it asks for the next one
            with span("train_step"):
                with span("sampler"):
                    batch = self._draw(perm, b)
                yield batch

    def _draw(self, perm, b):
        """Batch `b` of the epoch's permutation, its negatives drawn."""
        bs = self.train_batch_size
        idx = perm[b * bs:(b + 1) * bs]  # the tail at its exact size
        u = self._train_u[idx]
        pos = self._train_i[idx]
        neg = sample_negatives(u, self._excl, self.num_items,
                               self.generator, n_tries=self.n_tries)
        extra = {}
        if self.pad_tail:
            extra["weight"] = (b * bs + torch.arange(
                bs, device=u.device) < self.n_train).float()
        if self.hns:
            extra["health_neg"] = sample_health_stratified_negatives(
                u, pos, self._excl, *self._health, self.generator,
                n_tries=self.n_tries)
        return (u, pos, neg, extra) if extra else (u, pos, neg)

    def train_epoch(self):
        """One pass over the train pairs in a fresh device permutation;
        returns the summed loss parts on the device. A non-finite chunk of
        `epoch_scan_chunk` steps ends the epoch early."""
        perm = self._epoch_perm()
        self.epoch_batch = 0
        self._epoch_cos_sim = None
        loss_parts = None
        for first in range(0, self.n_batches, self.chunk):
            parts = self.train_steps(self._batches(
                perm, first, min(first + self.chunk, self.n_batches)))
            loss_parts = parts if loss_parts is None else loss_parts + parts
            if self.chunk < self.n_batches and not torch.isfinite(parts).all():
                break
        return loss_parts

    def _traced_epoch(self, trace_dir):
        """train_epoch under torch.profiler (CPU, and CUDA on the card), its
        chrome trace written to `trace_dir`/epoch_1.pt.trace.json."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.model.device.type == "cuda"
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            loss_parts = self.train_epoch()
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "epoch_1.pt.trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace of epoch 1: {path}")
        return loss_parts

    # ------------------------------------------------------------------- fit
    def fit(self, dataset, valid_data=None, test_data=None, hyper_tuple=None,
            saved=False):
        """Train for config['epochs'] epochs (fewer on early stop or a NaN
        loss, none with `req_training: False`), evaluating every
        `eval_step`; returns (best valid score, best valid metrics, test
        metrics of the best parameters), and leaves the best parameters in
        the model. The eval sets default to `dataset.device_data`'s.
        `saved` writes each new best to
        `{ckp_root}/{model}-{dataset}-{hyper_parameters}={hyper_tuple}.pkl`,
        the JAX package's name."""
        config = self.config
        dd = dataset.device_data
        valid_data = dd.eval_valid if valid_data is None else valid_data
        test_data = dd.eval_test if test_data is None else test_data
        ckp_root = config["ckp_root"] or "./ckp/"
        ckpt_path = os.path.join(
            ckp_root,
            f"{config['model']}-{config['dataset']}-"
            f"{config['hyper_parameters']}={hyper_tuple}.pkl")

        start_epoch = cur_step = 0
        if config["resume_from"]:
            start_epoch, cur_step = self._resume(config["resume_from"])
        best_state = self._host_snapshot()

        # epoch 1 under the profiler, epoch 0 paying the warm-up
        # (trainer.py:534-547)
        trace_dir = config["profile_trace_dir"]
        for epoch_idx in range(start_epoch, self.epochs):
            t0 = time.time()
            if self.req_training:
                if trace_dir and epoch_idx == 1:
                    loss_parts = self._traced_epoch(trace_dir)
                else:
                    loss_parts = self.train_epoch()
                loss_parts = loss_parts.cpu().numpy()
                if not np.isfinite(loss_parts).all():
                    self.logger.info(
                        f"Loss is nan at epoch: {epoch_idx}. Exiting.")
                    break
                self.train_loss_dict[epoch_idx] = float(loss_parts.sum())
                lr_now = self.scheduler.get_last_lr()[0]
                parts_str = ", ".join(
                    f"train_loss{i + 1}: {v / self.n_batches:.4f}"
                    for i, v in enumerate(loss_parts))
                self.logger.info(
                    f"epoch {epoch_idx} training [time: "
                    f"{time.time() - t0:.2f}s, lr: {lr_now:.6f}, {parts_str}]")
                if self.probe_on and self._epoch_cos_sim is not None:
                    c = self._epoch_cos_sim.tolist()
                    self.logger.info(
                        "cos-sim (summed over batches) [id-text: "
                        f"{c[0]:.4f}, grad: {c[1]:.4f}, id-image: {c[2]:.4f}, "
                        f"grad: {c[3]:.4f}, pos(text>id): {c[4]:.4f}, "
                        f"pos(image>id): {c[5]:.4f}]")
                self.scheduler.step()

            every = config["save_state_every"]
            if every and (epoch_idx + 1) % every == 0:
                # the JAX package's name, sanitized for its tensorstore
                name = re.sub(r"[^A-Za-z0-9._=,-]", "_",
                              os.path.basename(ckpt_path)) + ".state"
                self._save_state(os.path.join(ckp_root, name), epoch_idx,
                                 cur_step)

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
                    if saved and self.writer:
                        os.makedirs(ckp_root, exist_ok=True)
                        ckpt.save_best(best_state, ckpt_path)
                        self.logger.info(f"Saving current best: {ckpt_path}")
                if stop_flag:
                    self.logger.info(
                        f"+++++Finished training, best eval result in epoch "
                        f"{epoch_idx - cur_step * self.eval_step}")
                    break

        # the final test on the best-on-valid parameters (trainer.py:614-617)
        self.model.load_full_state_dict(best_state)
        _, best_test_upon_valid = self._valid(test_data, is_test=True)
        return (self.best_valid_score, self.best_valid_result,
                best_test_upon_valid)

    def _host_snapshot(self):
        """The whole state_dict on the host (row-sharded tables gathered)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.full_state_dict().items()}

    def _sharded_state_ids(self):
        """{optimizer state index: (first row, local rows, full rows)} of
        the row-sharded tables (the optimizer holds model.parameters() in
        order)."""
        shards = self.model.row_shards
        return {i: (shards[n][0], p.shape[0], shards[n][1]) for i, (n, p) in
                enumerate(self.model.named_parameters()) if n in shards}

    def _full_optimizer_state(self):
        """optimizer.state_dict() with the row-sharded tables' moments
        gathered whole (a collective over `model`)."""
        state = self.optimizer.state_dict()
        ids = self._sharded_state_ids()
        if not ids:
            return state
        state["state"] = {k: dict(v) for k, v in state["state"].items()}
        for i, (_, rows, _) in ids.items():
            for key, v in state["state"].get(i, {}).items():
                if torch.is_tensor(v) and v.dim() and v.shape[0] == rows:
                    state["state"][i][key] = coll.all_gather(
                        v, self.mesh.group("model"))
        return state

    def _load_optimizer_state(self, state):
        """Load a whole optimizer state, keeping this rank's rows of the
        row-sharded tables' moments."""
        ids = self._sharded_state_ids()
        if ids:
            state = dict(state)
            state["state"] = {k: dict(v) for k, v in state["state"].items()}
            for i, (first, rows, full) in ids.items():
                for key, v in state["state"].get(i, {}).items():
                    if torch.is_tensor(v) and v.dim() and v.shape[0] == full:
                        state["state"][i][key] = v[first:first + rows]
        self.optimizer.load_state_dict(state)

    def _save_state(self, path, epoch, cur_step):
        model_state = self.model.full_state_dict()
        optimizer_state = self._full_optimizer_state()
        if not self.writer:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ckpt.save_state(
            path, model_state, optimizer_state,
            {"scheduler": self.scheduler.state_dict(),
             "n_updates": self.n_updates},
            self.generator.get_state(), epoch, self.best_valid_score,
            cur_step, self.train_loss_dict)

    def _resume(self, path):
        """Load a `save_state` file into the model, optimizer, lr schedule
        and generator; returns (first epoch to run, cur_step). As in the JAX
        package, the best parameters start as the resumed ones and the best
        valid result as None."""
        state = ckpt.load_state(path)
        self.model.load_full_state_dict(state["model"])
        self._load_optimizer_state(state["optimizer"])
        self.scheduler.load_state_dict(state["schedule"]["scheduler"])
        self.n_updates = state["schedule"]["n_updates"]
        self.generator.set_state(state["generator"])
        self.best_valid_score = state["best_valid_score"]
        self.train_loss_dict.update(state["train_loss_dict"])
        start_epoch = state["epoch"] + 1
        self.logger.info(f"resumed from {path} at epoch {start_epoch}")
        return start_epoch, state["cur_step"]

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def _valid(self, eval_set, is_test=False):
        """Dispatch between the reference's three eval paths
        (trainer.py:428-437): eval_by_user (default) > full_sort > sampled.
        Under a mesh every rank returns rank 0's (score, metrics)."""
        with span("eval_pass"):
            if self.config["eval_by_user"]:
                out = self._valid_by_user(eval_set)
            elif self.config["full_sort"]:
                out = self._valid_full_sort(is_test)
            else:
                out = self._valid_sample(is_test)
            if self.mesh is not None and self.mesh.world_size > 1:
                box = [out]
                dist.broadcast_object_list(box, src=0)
                out = box[0]
        return out

    def _eval_batch(self):
        """The user block of by-user, sampled and study evaluation:
        `eval_batch_size`, capped by the model's `eval_batch_cap`."""
        cap = getattr(self.model, "eval_batch_cap", None)
        return min(self.eval_batch_size, cap) if cap else self.eval_batch_size

    def _score_fn(self):
        """score_from_cache bound to a fresh eval_cache (the graph
        propagation, once per evaluation)."""
        with span("eval_cache"):
            cache = self.model.eval_cache()
        return functools.partial(self.model.score_from_cache, cache)

    def _valid_by_user(self, eval_set):
        return evaluate_by_user(self._score_fn(), eval_set,
                                self.neg_sample_num,
                                batch_size=self._eval_batch(),
                                device=self.model.device)

    @torch.no_grad()
    def _valid_full_sort(self, is_test, idx=0):
        """Full-catalog ranking -> TopKEvaluator metrics (trainer.py:646-694;
        reference trainer.py:476-503): every user on the test split, the
        valid users otherwise, in blocks of min(eval_batch_size, 64). The
        score is `valid_metric` lower-cased (`ndcg@20`)."""
        model = self.model
        ds = model.dataset
        if is_test:
            users = list(range(ds.num_users))
            pos_items = ds.testRatings
        else:
            users = ds.valid_users
            pos_items = ds.validRatings
        pos_len = [len(p) for p in pos_items]

        evaluator = TopKEvaluator(self.config)
        evaluator.save_recom_result = (bool(evaluator.save_recom_result)
                                       and self.writer)
        with span("eval_cache"):
            cache = model.eval_cache()
        # item-sharded over a `model` axis when the model scores by the
        # base dot product (trainer.py:663-671); SCHGN's scorer sweeps
        # replicated
        sweep = full_sort_topk
        if (self.mesh is not None and self.mesh.size("model") > 1
                and type(model).score_items
                is GeneralRecommender.score_items):
            sweep = functools.partial(distributed_full_sort_topk, self.mesh)
        topk_index = sweep(
            functools.partial(model.score_items, cache), users, ds.num_items,
            max(evaluator.topk), user_batch=min(self.eval_batch_size, 64),
            device=model.device)
        with span("topk_metrics"):
            result = evaluator.evaluate(topk_index.numpy(),
                                        (users, pos_items, pos_len),
                                        is_test=is_test, idx=idx)
        valid_metric = (self.config["valid_metric"] or "NDCG@20").lower()
        score = result.get(valid_metric, result.get("ndcg@20", 0.0))
        return score, result

    def _sample_candidates(self, is_test):
        """(users [R], candidates [R, K + 1]) of the sampled eval: one row
        per positive, its user's K negatives then the positive
        (trainer.py:702-714; reference dataloader.py:174-220)."""
        ds = self.model.dataset
        if is_test:
            per_user = zip(range(ds.num_users), ds.testRatings,
                           ds.testNegatives)
        else:
            per_user = zip(ds.valid_users, ds.validRatings, ds.validNegatives)
        users, ratings, negatives = zip(*per_user)
        n_pos = np.array([len(p) for p in ratings])
        row_user = np.repeat(np.arange(len(users)), n_pos)
        cand = np.concatenate(
            [np.stack(negatives).astype(np.int64)[row_user],
             np.concatenate(ratings).astype(np.int64)[:, None]], axis=1)
        return np.asarray(users, np.int64)[row_user], cand

    @torch.no_grad()
    def _valid_sample(self, is_test):
        """Sampled rank-of-positive eval (trainer.py:696-730; reference
        trainer.py:298-349): each positive scored among [its user's
        negatives, itself], in blocks of `_eval_batch()` rows, the last
        padded with zeros; the metrics on the host (`sample_rank_metrics`).
        The score is NDCG@20."""
        users, cand = self._sample_candidates(is_test)
        score_fn = self._score_fn()
        bs = self._eval_batch()
        pad = (-len(users)) % bs
        dev = self.model.device
        users_p = torch.from_numpy(np.concatenate(
            [users, np.zeros(pad, users.dtype)])).to(dev)
        cand_p = torch.from_numpy(np.concatenate(
            [cand, np.zeros((pad, cand.shape[1]), cand.dtype)])).to(dev)
        preds = [score_fn(users_p[s:s + bs], cand_p[s:s + bs])
                 for s in range(0, len(users_p), bs)]
        pred_list = torch.cat(preds)[:len(users)].cpu().numpy()
        result = sample_rank_metrics(pred_list, self.neg_sample_num)
        return result["NDCG@20"], result

    def evaluate(self, eval_set, is_test=False):
        return self._valid(eval_set, is_test)[1]

    # ----------------------------------------------------------- study evals
    # The reference exposes cold/warm, sense/unsense and per-health-level
    # by-user evals as trainer methods over dedicated feeders
    # (trainer.py:631-804; dataloader.py:305-499). Here, as in the JAX
    # package (trainer.py:742-787), each split is one padded EvalSet through
    # the by-user evaluator, with its per-user metric arrays and raw scores.
    @torch.no_grad()
    def _study_eval(self, users, ratings, negatives):
        """(metrics, per-user metric arrays, scores [U, C]) of one split."""
        es = build_eval_set(users, ratings, negatives)
        _, metrics, per_user, preds = evaluate_by_user(
            self._score_fn(), es, self.neg_sample_num,
            batch_size=self._eval_batch(), device=self.model.device,
            return_per_user=True)
        return metrics, per_user, preds

    def cold_start_study(self):
        """Needs the `cold_study` splits (trainer.py:755-763)."""
        ds = self.model.dataset
        cold = self._study_eval(ds.cold_users, ds.coldRatings,
                                ds.coldNegatives)
        warm = self._study_eval(ds.warm_users, ds.warmRatings,
                                ds.warmNegatives)
        return {"cold": cold[0], "warm": warm[0],
                "cold_predictions": cold[2], "warm_predictions": warm[2]}

    def sense_study(self):
        """Needs the `sense_study` splits (trainer.py:765-774)."""
        ds = self.model.dataset
        sense = self._study_eval(ds.sense_users, ds.senseRatings,
                                 ds.senseNegatives)
        unsense = self._study_eval(ds.unsense_users, ds.unsenseRatings,
                                   ds.unsenseNegatives)
        return {"sense": sense[0], "unsense": unsense[0],
                "sense_predictions": sense[2],
                "unsense_predictions": unsense[2]}

    def health_level_study(self, n_levels=6):
        """Needs the `health_level_study` splits (trainer.py:776-787); a
        level without users is left out."""
        ds = self.model.dataset
        out = {}
        for hl in range(n_levels):
            if not len(ds.healthUsers[hl]):
                continue
            metrics, _, _ = self._study_eval(
                ds.healthUsers[hl], ds.healthRatings[hl],
                ds.healthNegatives[hl])
            out[f"health_{hl}"] = metrics
        return out

    def plot_train_loss(self, show=False, path=None):
        """Epoch-loss curve (trainer.py:789-806; reference
        trainer.py:505-523); matplotlib is imported only here."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        epochs = sorted(self.train_loss_dict)
        plt.figure()
        plt.plot(epochs, [self.train_loss_dict[e] for e in epochs])
        plt.xticks(epochs)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        if path:
            plt.savefig(path)
        if show:
            plt.show()
        plt.close()

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def load_checkpoint(path):
        """The best-on-valid state_dict `fit(saved=True)` wrote, on the
        host, for `model.load_state_dict`."""
        return ckpt.load_best(path)


def _flat_collective(params, op):
    """op on one flat buffer of the params' gradients, copied back."""
    if not params:
        return
    flat = op(torch.cat([p.grad.reshape(-1) for p in params]))
    at = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[at:at + n].view_as(p.grad))
        at += n


def get_trainer():
    """Registry hook (reference: utils.py:43-44)."""
    return Trainer
