"""Training traffic: `Trainer.train_epoch`, epoch after epoch, closed loop,
each epoch a fresh permutation of the train pairs cut into batches of
`train_batch_size` with the last one at its exact size, one negative per
pair drawn on the device.

Set-up builds one Trainer from the seed's weights and drives it through
its first `compared_steps` steps by the window's own call (train_epoch,
stopped after them), recording each step's batch, dropout draws and loss
parts, the first gradient as Adam holds it after one step, and each
leaf's change after the last; then one step at the epoch's tail size, so
that every shape the window uses has run. The window hands on the same
Trainer. After it, the plain reference follows the recorded steps from the
same weights and judges the program's numbers.
"""

import math
import statistics
import time

import numpy as np

from portbench import harness


class _Stop(Exception):
    """Raised from the optimizer's step hook to end train_epoch."""


class _Recorder:
    """Records the compared steps' batches, loss parts and dropout draws,
    by wrapping the model's calculate_loss and the port's dropout."""

    def __init__(self, model):
        import torch

        import foodrec_tpu_torch.common.module as module

        self.model, self.module = model, module
        self.batches, self.parts, self.masks = [], [], []
        self._loss, self._drop = model.calculate_loss, module.dropout

        def calculate_loss(u, pos, neg, generator=None, weight=None):
            self.batches.append((u.clone(), pos.clone(), neg.clone()))
            self.masks.append([])
            out = self._loss(u, pos, neg, generator=generator, weight=weight)
            self.parts.append([float(p.detach()) for p in out])
            return out

        def dropout(x, rate, generator, rows=False):
            if not rate:
                return self._drop(x, rate, generator, rows=rows)
            # the same draw again, on ones: the keep mask itself, also
            # where x is 0
            state = generator.get_state()
            keep = self._drop(torch.ones_like(x), rate, generator,
                              rows=rows) != 0
            generator.set_state(state)
            self.masks[-1].append(keep)
            return self._drop(x, rate, generator, rows=rows)

        model.calculate_loss = calculate_loss
        module.dropout = dropout

    def close(self):
        del self.model.calculate_loss
        self.module.dropout = self._drop
        self.model = self._loss = None  # the program's state is freed later


def _leaf_norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def setup(ctx):
    import torch
    from foodrec_tpu_torch.engine.trainer import Trainer

    weights = ctx.weights()
    cfg, _, model = ctx.build_program(weights)
    trainer = Trainer(cfg, model)
    n_steps = ctx.traffic["compared_steps"]
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    first_grad, change = {}, {}
    steps = [0]

    def hook(opt, args, kwargs):
        steps[0] += 1
        if steps[0] == 1:
            # Adam's first moment after one step is (1 - beta1) * gradient;
            # a step that kept no state read as a zero gradient
            b1 = opt.param_groups[0]["betas"][0]
            first_grad.update(_leaf_norms(
                {k: opt.state[p]["exp_avg"] / (1 - b1)
                 if "exp_avg" in opt.state.get(p, {}) else torch.zeros(())
                 for k, p in params.items()}))
        if steps[0] == n_steps:
            change.update({k: p.detach() - start[k]
                           for k, p in params.items()})
            raise _Stop

    rec = _Recorder(model)
    handle = trainer.optimizer.register_step_post_hook(hook)
    try:
        trainer.train_epoch()
    except _Stop:
        pass
    finally:
        handle.remove()
        rec.close()
    del start
    if len(rec.batches) != n_steps:
        raise RuntimeError(f"{len(rec.batches)} batches in the first "
                           f"{n_steps} steps")
    # the epoch's last batch has its exact size: run that shape once
    tail = trainer.n_train % trainer.train_batch_size
    if tail:
        u, pos, neg = rec.batches[0]
        trainer.train_steps([(u[:tail], pos[:tail], neg[:tail])])
    harness.sync(ctx.device)
    return {"trainer": trainer, "model": model, "weights": weights,
            "record": rec, "first_grad": first_grad, "change": change}


def window(ctx, st, seconds):
    """Runs train_epoch until `seconds` have passed; the window ends on a
    synchronize after the step that crossed the deadline. Counts the steps
    and the pairs they trained."""
    trainer = st["trainer"]
    bs, n_train = trainer.train_batch_size, trainer.n_train
    count = {"steps": 0, "pairs": 0}
    sizes = {}
    deadline = [math.inf]

    def hook(opt, args, kwargs):
        b = min(bs, n_train - trainer.epoch_batch * bs)
        count["steps"] += 1
        count["pairs"] += b
        sizes[b] = sizes.get(b, 0) + 1
        if time.perf_counter() >= deadline[0]:
            raise _Stop

    handle = trainer.optimizer.register_step_post_hook(hook)
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    deadline[0] = t0 + seconds
    try:
        while True:
            trainer.train_epoch()
    except _Stop:
        pass
    finally:
        handle.remove()
    harness.sync(ctx.device)
    t1 = time.perf_counter()
    return {"t_start": t0, "window_s": t1 - t0, "units": count["steps"],
            "steps": count["steps"], "pairs": count["pairs"],
            "steps_by_batch": sizes}


def release(st):
    for k in ("trainer", "model"):
        st.pop(k, None)


def reference_steps(ref, w, batches, masks, lr_of, tf32=False, half=False):
    """The reference's steps over the batches from weights `w` (modified in
    place): (losses, first-gradient norms by leaf, changes by leaf, and by
    leaf the largest |gradient| of each element over the steps). `half` is
    the planted fault: each step's loss over the first half of its batch
    alone."""
    import torch

    from portbench.reference import plain

    w0 = {k: v.detach().clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(True)
    state, losses, first = {}, [], None
    with plain.precision(tf32):
        for step, (u, pos, neg) in enumerate(batches):
            m = list(masks[step])
            if half:
                b, h = u.shape[0], u.shape[0] // 2
                u, pos, neg = u[:h], pos[:h], neg[:h]
                # the masks' rows are [positives; negatives] of the batch
                m = [torch.cat([x[:h], x[b:b + h]]) for x in m]
            parts = ref.loss_parts(w, u, pos, neg, m)
            if m:
                raise ValueError(f"{len(m)} dropout draws left over")
            loss = sum(parts)
            grads = torch.autograd.grad(loss, list(w.values()),
                                        allow_unused=True)
            grads = dict(zip(w, grads))
            if first is None:
                first = _leaf_norms(grads)
                gmax = {k: g.abs() for k, g in grads.items()}
            else:
                gmax = {k: torch.maximum(gmax[k], g.abs())
                        for k, g in grads.items()}
            plain.adam(w, grads, state, lr_of(step))
            losses.append(float(loss.detach()))
    change = {k: w[k].detach() - w0[k] for k in w}
    return losses, first, change, gmax


def gaps(prog, ref):
    """The compared numbers of the program's (or a control's) steps, (losses,
    first-gradient norms, changes), against the reference's.

    loss_gap: the widest |loss - reference loss| / |reference loss| over
    the steps. grad_gap: by the worst leaf, the gap between the two norms
    of the first gradient over the larger of the reference's norm of that
    leaf and of the median leaf. change_gap: the same of the norms of each
    leaf's change over the steps, taken over the elements whose reference
    gradient reached a thousandth of their leaf's root mean square in some
    step: the others (a key's bias under softmax) have a gradient that is
    round-off, which Adam turns into moves of about the learning rate in
    either direction."""
    (pl, pg, pc), (rl, rg, rc, gmax) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    med_g = statistics.median(rg.values())
    grad_gap = max(abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg)
    pn, rn = {}, {}
    for k in rc:
        g = gmax[k].double()
        counted = g >= 1e-3 * g.pow(2).mean().sqrt()
        if counted.any():
            pn[k] = float(pc[k][counted].double().norm())
            rn[k] = float(rc[k][counted].double().norm())
    med_c = statistics.median(rn.values())
    change_gap = max(abs(pn[k] - rn[k]) / max(rn[k], med_c) for k in rn)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def lr_schedule(mc, data):
    """The learning rate of update `count`: lr0 * s0 ** ((count //
    batches an epoch) / s1), as the configuration's scheduler sets it."""
    s0, s1 = mc.get("learning_rate_scheduler") or (1.0, 50)
    n_batches = -(-len(data["train_u"]) // mc["train_batch_size"])
    return lambda count: mc["learning_rate"] * s0 ** ((count // n_batches)
                                                      / s1)


def check(ctx, st, data):
    """[(name, value, limit)] of the compared numbers."""
    from portbench.reference import plain

    rec = st["record"]
    ref = ctx.cell.reference.Reference(data, ctx.config["model_config"],
                                       ctx.device)
    w = ctx.reference_weights(st["weights"], data)
    ref_out = reference_steps(ref, w, rec.batches, rec.masks,
                              lr_schedule(ctx.config["model_config"], data))
    prog = ([sum(p) for p in rec.parts], st["first_grad"], st["change"])
    g = gaps(prog, ref_out)
    users = np.concatenate([b[0].cpu().numpy() for b in rec.batches])
    negs = np.concatenate([b[2].cpu().numpy() for b in rec.batches])
    bad = int(plain.positives_mask(data, users, negs).sum()
              + ((negs < 0) | (negs >= data["n_items"])).sum())
    lim = ctx.cell.limits
    return [("loss_gap", g["loss_gap"], lim["loss_gap"]),
            ("grad_gap", g["grad_gap"], lim["grad_gap"]),
            ("change_gap", g["change_gap"], lim["change_gap"]),
            ("bad_negatives", bad, lim["bad_negatives"])]
