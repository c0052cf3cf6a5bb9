"""Readings from which each cell's limits are set, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--seconds S] [--out FILE]

For each seed of `--seeds`, one run of the cell as the benchmark makes it
(set-up, a window of `--seconds`, the reference's check): the program's
compared numbers, whose largest over sound seeds is each number's lower
reading. For each seed of `--control-seeds`, the control: the plain
reference put in the program's place and computed with TF32 on, the
precision below the configuration's float32 (a training cell: on steps of
the control's own batches and dropout draws; an evaluation cell: the
scores of every user; a top-k cell: the top-k of as many requests as a
run judges; an evaluation cell's reading with TF32 on is kept, as
`reference_tf32`, though TF32 leaves its path as it is, and its control is
the program with its own bfloat16 SpMM path on); for a training cell the faults of half of each
batch left out (the reference's loss over the first half alone) and of a
state left unchanged (learning rate 0); each judged by the cell's own
comparison against the float32 reference. One JSON line a
reading, to standard output and to `--out`.
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

from portbench import harness, run


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _control_batches(ctx, data, ref, n_steps):
    """n_steps batches of distinct train rows drawn from the seed, a
    negative each that is no positive of its user, and the dropout draws
    of each step."""
    import torch

    from portbench.reference import plain

    mc = ctx.config["model_config"]
    bs = mc["train_batch_size"]
    rng = np.random.default_rng(ctx.seed)
    rows = rng.permutation(len(data["train_u"]))[:n_steps * bs]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    batches, masks = [], []
    keep = 1.0 - mc.get("attention_probs_dropout_prob", 0.0)
    for s in range(n_steps):
        r = rows[s * bs:(s + 1) * bs]
        u, pos = data["train_u"][r], data["train_i"][r]
        neg = rng.integers(0, data["n_items"], size=bs)
        bad = plain.positives_mask(data, u, neg)
        while bad.any():
            neg[bad] = rng.integers(0, data["n_items"], size=int(bad.sum()))
            bad = plain.positives_mask(data, u, neg)
        batches.append(tuple(torch.from_numpy(a).to(ctx.device)
                             for a in (u, pos, neg)))
        masks.append([torch.rand(shape, generator=gen, device=ctx.device)
                      < keep for shape in ref.mask_shapes(bs)])
    return batches, masks


def control(ctx, data):
    """{number: reading} of the control, and of the half-batch fault for a
    training cell, on this context's seed."""
    kind = ctx.traffic["kind"]
    mc = ctx.config["model_config"]
    ref = ctx.cell.reference.Reference(data, mc, ctx.device)
    w_seed = ctx.weights()
    out = {}
    if kind == "train":
        from portbench.traffic import train

        n = ctx.traffic["compared_steps"]
        batches, masks = _control_batches(ctx, data, ref, n)
        lr = train.lr_schedule(mc, data)
        exact = train.reference_steps(
            ref, ctx.reference_weights(w_seed, data), batches, masks, lr)
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"half": True}),
                         ("fault_state_unchanged",
                          {"lr_of": lambda count: 0.0})):
            kw = {"lr_of": lr, **kw}
            low = train.reference_steps(
                ref, ctx.reference_weights(w_seed, data), batches, masks,
                **kw)
            out[name] = train.gaps(low[:3], exact)
    elif kind == "eval":
        import torch

        # the program's own lower-precision path: its SpMM on x rounded to
        # bfloat16; TF32 leaves this path unchanged (its products are
        # matrix-vector products, which do not run on the tensor cores)
        cell = harness.Cell(ctx.cell.name)
        cell.config = copy.deepcopy(ctx.config)
        cell.config["model_config"]["spmm_dtype"] = "bfloat16"
        res = run.measure(cell.name, ctx.seed, 1.0, False, cell=cell)
        out["control_program_bf16"] = {k: v["value"]
                                       for k, v in res["checks"].items()}

        from portbench.reference import plain
        from portbench.traffic import eval as ev

        cand, n_pos, n_cand = plain.test_candidates(data)
        w = ctx.reference_weights(w_seed, data)
        exact = ev.reference_scores(ctx, ref, w, cand)
        low = ev.reference_scores(ctx, ref, w, cand, tf32=True)
        per_user = plain.by_user_metrics(
            low, torch.as_tensor(n_pos, device=ctx.device),
            torch.as_tensor(n_cand, device=ctx.device), mc["neg_sample_num"])
        results = [{"AUC": float(per_user["AUC"].mean())}]
        # not a control here: TF32 leaves this path as it is
        out["reference_tf32"] = ev.gaps(low, exact, results, n_pos, n_cand,
                                        mc["neg_sample_num"])
    else:
        from portbench.traffic import topk

        t = ctx.traffic
        blocks = topk._blocks(ctx.shapes["n_users"], t["users_per_request"],
                              ctx.seed)
        users = np.concatenate([next(blocks)
                                for _ in range(t["sample_requests"])])
        w = ctx.reference_weights(w_seed, data)
        out["control_tf32"] = {"rank_gap": topk.reference_topk_gap(
            ctx, ref, w, users, None, tf32=True)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench.reference import plain

    if not torch.cuda.is_available():
        harness.log("calibration reads the card: CUDA is not available")
        return 3
    device = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        t = time.perf_counter()
        res = run.measure(args.workload, seed, args.seconds, False,
                          start=time.perf_counter())
        _emit(args.out, {"workload": args.workload, "seed": seed,
                         "side": "program", "device": device,
                         "correct": res["correct"],
                         "checks": {k: v["value"]
                                    for k, v in res["checks"].items()},
                         "s": time.perf_counter() - t})
        torch.cuda.empty_cache()
    if args.control_seeds:
        harness.cache_environment()
        cell = harness.Cell(args.workload)
        data = None
        for seed in args.control_seeds:
            ctx = harness.Context(cell, seed, "cuda")
            if data is None:
                data = plain.load_dataset(os.path.join(
                    ctx.data_root, cell.config["data"]["name"]))
            for side, nums in control(ctx, data).items():
                _emit(args.out, {"workload": args.workload, "seed": seed,
                                 "side": side, "device": device,
                                 "checks": nums})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
