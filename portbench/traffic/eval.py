"""By-user evaluation traffic: `Trainer.evaluate` on the test split, pass
after pass, closed loop: every user with its positives and its sampled
negatives, in blocks of `eval_batch_size`, one `eval_cache` a pass, the
metrics on the host at the end of each pass.

Set-up builds the model from the seed's weights and runs one pass. In the
window every pass's metrics are kept, and the scores of the pass under way
(the model's score_from_cache is wrapped to keep its outputs). After it,
the plain reference scores the same users' candidate lists from the same
weights and computes the metrics.
"""

import time

import numpy as np

from portbench import harness


def setup(ctx):
    from foodrec_tpu_torch.engine.trainer import Trainer

    weights = ctx.weights()
    cfg, fd, model = ctx.build_program(weights)
    trainer = Trainer(cfg, model)
    eval_set = getattr(fd.device_data, "eval_" + ctx.traffic["split"])
    scores = []
    score_from_cache = model.score_from_cache

    def recorded(cache, users, cand):
        out = score_from_cache(cache, users, cand)
        scores.append(out)
        return out

    model.score_from_cache = recorded
    st = {"trainer": trainer, "model": model, "weights": weights,
          "eval_set": eval_set, "scores": scores, "results": []}
    _pass(st)
    st["results"].clear()
    harness.sync(ctx.device)
    return st


def _pass(st):
    st["scores"].clear()
    st["results"].append(st["trainer"].evaluate(
        st["eval_set"], is_test=True))


def window(ctx, st, seconds):
    """Whole passes until `seconds` have passed."""
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    passes = 0
    while True:
        _pass(st)
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    n = st["eval_set"].n_users
    return {"t_start": t0, "window_s": t1 - t0, "units": passes,
            "passes": passes, "users": passes * n}


def release(st):
    import torch

    n = st["eval_set"].n_users
    st["program_scores"] = torch.cat(st.pop("scores"))[:n]
    for k in ("trainer", "model", "eval_set"):
        st.pop(k, None)


def reference_scores(ctx, ref, w, cand, block=256, tf32=False):
    """The reference's scores [U, W] of the candidate lists, in blocks."""
    import torch

    from portbench.reference import plain

    with plain.precision(tf32):
        cache = ref.eval_cache(w)
        users = torch.arange(len(cand), device=ctx.device)
        cand = torch.from_numpy(cand).to(ctx.device)
        with torch.no_grad():
            return torch.cat([ref.score(cache, users[s:s + block],
                                        cand[s:s + block])
                              for s in range(0, len(cand), block)])


def gaps(scores, ref_scores, results, n_pos, n_cand, neg_num):
    """score_gap: the widest |score - reference score| over the largest
    |reference score|, over every user's valid candidates. auc_gap: the
    widest gap between a pass's mean AUC and the reference's. (The ranking
    metrics are not compared: one positive and one negative that trade
    places in one user's top 20, as float32 rounding can make them, move
    a mean NDCG by about 1e-5, as far as a lower precision moves it.)"""
    import torch

    from portbench.reference import plain

    dev = ref_scores.device
    w = min(scores.shape[1], ref_scores.shape[1])
    slot = torch.arange(ref_scores.shape[1], device=dev)[None, :]
    valid = slot < torch.as_tensor(n_cand, device=dev)[:, None]
    if scores.shape[1] < ref_scores.shape[1] and valid[:, w:].any():
        return {"score_gap": float("inf"), "auc_gap": float("inf")}
    diff = (scores[:, :w].to(dev) - ref_scores[:, :w]).abs()
    scale = ref_scores[valid].abs().max()
    score_gap = float(torch.where(valid[:, :w], diff, 0.0).max() / scale)
    n_pos_t = torch.as_tensor(n_pos, device=dev)
    n_cand_t = torch.as_tensor(n_cand, device=dev)
    auc = np.concatenate([
        plain.by_user_metrics(ref_scores[s:s + 256], n_pos_t[s:s + 256],
                              n_cand_t[s:s + 256], neg_num)["AUC"]
        for s in range(0, len(ref_scores), 256)]).mean()
    auc_gap = max(abs(r["AUC"] - auc) for r in results)
    return {"score_gap": score_gap, "auc_gap": float(auc_gap)}


def check(ctx, st, data):
    from portbench.reference import plain

    mc = ctx.config["model_config"]
    ref = ctx.cell.reference.Reference(data, mc, ctx.device)
    w = ctx.reference_weights(st["weights"], data)
    cand, n_pos, n_cand = plain.test_candidates(data)
    ref_scores = reference_scores(ctx, ref, w, cand)
    g = gaps(st["program_scores"], ref_scores, st["results"], n_pos, n_cand,
             mc["neg_sample_num"])
    lim = ctx.cell.limits
    return [("score_gap", g["score_gap"], lim["score_gap"]),
            ("auc_gap", g["auc_gap"], lim["auc_gap"])]
