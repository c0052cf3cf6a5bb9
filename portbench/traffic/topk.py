"""Top-k request traffic: `full_sort_topk` requests, closed loop, one
caller. Each request is a block of `users_per_request` distinct users,
drawn from the seed (the users in shuffled order, cut into blocks, a fresh
shuffle when they run out), ranked over the full catalog in chunks of
`item_chunk` items for their top `k`, with `score_items` over one
`eval_cache` built in set-up. A request is timed from the call to the
moment its ids are on the host.

After the window a sample of the requests, drawn from the seed, is judged
against the plain reference's scores of the full catalog.
"""

import functools
import time

import numpy as np

from portbench import harness


def _blocks(n_users, per, seed):
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n_users)
        for s in range(0, n_users - per + 1, per):
            yield perm[s:s + per]


def setup(ctx):
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    weights = ctx.weights()
    cfg, fd, model = ctx.build_program(weights)
    t = ctx.traffic
    score_fn = functools.partial(model.score_items, model.eval_cache())

    def request(users):
        return full_sort_topk(score_fn, users, fd.n_items, t["k"],
                              user_batch=t["users_per_request"],
                              item_chunk=t["item_chunk"], device=ctx.device)

    st = {"model": model, "weights": weights, "request": request,
          "blocks": _blocks(fd.n_users, t["users_per_request"], ctx.seed),
          "users": [], "ids": []}
    for _ in range(t["warmup_requests"]):
        request(next(st["blocks"]))
    harness.sync(ctx.device)
    return st


def window(ctx, st, seconds):
    """Requests until `seconds` have passed; every request's latency."""
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    lat = []
    while True:
        users = next(st["blocks"])
        t_send = time.perf_counter()
        ids = st["request"](users)
        t_done = time.perf_counter()
        lat.append(t_done - t_send)
        st["users"].append(users)
        st["ids"].append(ids.numpy())
        if t_done - t0 >= seconds:
            break
    return {"t_start": t0, "window_s": t_done - t0, "units": len(lat),
            "requests": len(lat), "latency_s": lat}


def release(st):
    for k in ("model", "request"):
        st.pop(k, None)


def rank_gap(ref_scores, ids):
    """The widest gap, over rows and ranks j, between the reference's j-th
    best score and its score of the j-th returned id, over the row's
    largest |score|; inf for an id out of range or returned twice."""
    import torch

    n = ref_scores.shape[1]
    ids = torch.as_tensor(ids, device=ref_scores.device)
    if ((ids < 0) | (ids >= n)).any():
        return float("inf")
    if (ids.sort(dim=1).values.diff(dim=1) == 0).any():
        return float("inf")
    k = ids.shape[1]
    s = ref_scores.double()
    best = s.topk(k, dim=1).values
    got = s.gather(1, ids)
    scale = s.abs().max(dim=1).values
    return float(((best - got) / scale[:, None]).max())


def reference_topk_gap(ctx, ref, w, users, ids, tf32=False):
    """rank_gap of `ids` [R, k] (the program's, or None for the reference's
    own at `tf32`) against the float32 reference."""
    import torch

    from portbench.reference import plain

    n_items = ctx.shapes["n_items"]
    items = torch.arange(n_items, device=ctx.device)
    u = torch.as_tensor(np.asarray(users), device=ctx.device)
    with torch.no_grad():
        with plain.precision(False):
            exact = ref.score_items(ref.eval_cache(w), u, items)
        if ids is None:
            with plain.precision(tf32):
                low = ref.score_items(ref.eval_cache(w), u, items)
            ids = low.topk(ctx.traffic["k"], dim=1).indices
    return rank_gap(exact, ids)


def check(ctx, st, data):

    t = ctx.traffic
    rng = np.random.default_rng(ctx.seed + 1)
    n = len(st["ids"])
    pick = rng.choice(n, size=min(t["sample_requests"], n), replace=False)
    users = np.concatenate([st["users"][i] for i in pick])
    ids = np.concatenate([st["ids"][i] for i in pick])
    ref = ctx.cell.reference.Reference(data, ctx.config["model_config"],
                                       ctx.device)
    w = ctx.reference_weights(st["weights"], data)
    gap = reference_topk_gap(ctx, ref, w, users, ids)
    return [("rank_gap", gap, ctx.cell.limits["rank_gap"])]
