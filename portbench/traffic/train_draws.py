"""Training traffic whose steps draw more than dropout masks through the
shared `dropout`: the loop of `train` (traffic/train.py, reused as it is:
`Trainer.train_epoch` back to back, closed loop, a fresh permutation each
epoch, batches of `train_batch_size`, the last at its exact size, one
negative a pair drawn on the device), with a recorder that also records
SCHGN's own draws: the score dropout, which models/schgn.py calls by its
own name, and the masked-ingredient sequences of `ssl_mask_ingredients`.
Every draw is recorded from outside the program, in call order, and handed
to the plain reference, which consumes them in the same order: a draw left
over or missing fails the comparison.

The half-batch fault cuts each recorded draw to the first half of its own
batch (each of SCHGN's draws has the batch's rows first).
"""

from portbench import harness
from portbench.traffic import train


class _DrawRecorder(train._Recorder):
    """train's recorder, and SCHGN's score dropout and SSL sequences."""

    def __init__(self, model):
        import torch

        import foodrec_tpu_torch.models.schgn as schgn

        super().__init__(model)
        self.schgn = schgn
        self._schgn_drop = schgn.dropout
        self._mask = schgn.ssl_mask_ingredients

        def dropout(x, rate, generator, rows=False):
            if not rate:
                return self._schgn_drop(x, rate, generator, rows=rows)
            state = generator.get_state()
            keep = self._schgn_drop(torch.ones_like(x), rate, generator,
                                    rows=rows) != 0
            generator.set_state(state)
            self.masks[-1].append(keep)
            return self._schgn_drop(x, rate, generator, rows=rows)

        def ssl_mask_ingredients(*args, **kwargs):
            seqs = self._mask(*args, **kwargs)
            self.masks[-1].append(tuple(s.clone() for s in seqs))
            return seqs

        schgn.dropout = dropout
        schgn.ssl_mask_ingredients = ssl_mask_ingredients

    def close(self):
        self.schgn.dropout = self._schgn_drop
        self.schgn.ssl_mask_ingredients = self._mask
        super().close()


def _shapes(ctx):
    """The context's sizes with the configuration's calorie levels, which
    harness.shapes_of leaves out and SCHGN's level table needs."""
    ctx.shapes.setdefault("n_cal_levels",
                          ctx.config["data"]["params"]["n_cal_levels"])
    return ctx.shapes


def setup(ctx):
    _shapes(ctx)
    recorder, train._Recorder = train._Recorder, _DrawRecorder
    try:
        st = train.setup(ctx)
    finally:
        train._Recorder = recorder
    _log_model(st["model"])
    return st


def _log_model(model):
    """[setup] lines: the parameter count, and each graph's work plans (A's,
    and A^T's, the backward's, where A is not symmetric): rows, edges and
    the rows cut into slices."""
    n = sum(p.numel() for p in model.parameters())
    harness.log(f"[setup] {type(model).__name__}: {n} parameters")
    for name, m in model.named_modules():
        if type(m).__name__ != "Propagator":
            continue
        line = f"[setup] {name}: impl {m.impl}, {m.n_nodes} rows"
        for side, attr in (("A", "plan"), ("A^T", "t_plan")):
            plan = getattr(m, attr, None)
            if plan is not None:
                line += (f"; {side} {plan.nnz} edges, {plan.n_items} items,"
                         f" {plan.n_fix} cut rows")
        harness.log(line)


window = train.window
release = train.release


def _half(draw):
    if isinstance(draw, tuple):
        return tuple(_half(t) for t in draw)
    return draw[:draw.shape[0] // 2]


def reference_steps(ref, w, batches, draws, lr_of, tf32=False, half=False):
    """train.reference_steps over the recorded draws; `half`, the planted
    fault, takes each step over the first half of its batch and of each of
    its draws."""
    if half:
        batches = [tuple(t[:t.shape[0] // 2] for t in b) for b in batches]
        draws = [[_half(x) for x in step] for step in draws]
    return train.reference_steps(ref, w, batches, draws, lr_of, tf32=tf32)


# train.check hands the recorded draws to the reference as they are
check = train.check


def control(ctx, data):
    """{reading: numbers} on this context's seed, as calibrate.control
    reads a `train` cell's: on the control's own batches, with draws of the
    reference's own, the reference with TF32 on, the half-batch fault and
    the state left unchanged, each against the float32 reference."""
    import torch

    from portbench import calibrate

    _shapes(ctx)
    mc = ctx.config["model_config"]
    ref = ctx.cell.reference.Reference(data, mc, ctx.device)
    w_seed = ctx.weights()
    n = ctx.traffic["compared_steps"]
    batches, _ = calibrate._control_batches(ctx, data, _NoMasks(), n)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    draws = [ref.draws(*b, gen) for b in batches]
    lr = train.lr_schedule(mc, data)

    def steps(**kw):
        return reference_steps(ref, ctx.reference_weights(w_seed, data),
                               batches, draws, **{"lr_of": lr, **kw})

    exact = steps()
    return {name: train.gaps(steps(**kw)[:3], exact) for name, kw in (
        ("control_tf32", {"tf32": True}),
        ("fault_half_batch", {"half": True}),
        ("fault_state_unchanged", {"lr_of": lambda count: 0.0}))}


class _NoMasks:
    """calibrate._control_batches's reference, for batches alone."""

    @staticmethod
    def mask_shapes(batch):
        return []
