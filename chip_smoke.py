#!/usr/bin/env python3
"""The kernel table of the PyTorch/CUDA port (`foodrec_tpu_torch`) on one
NVIDIA H100: each hand-written CUDA kernel built, then timed alone at the
main path's shapes beside its byte bound, its plain PyTorch version and the
library call it stands in for.

    python3 chip_smoke.py

The kernels' checks are the `cuda` cases of the port's tests (`python3 -m
pytest -m cuda tests/test_torch_port_*.py`), the end-to-end and per-layer
measurements the benchmark's (`python3 -m portbench.run`). The shapes are
those of the benchmark's Foodcom-scale dataset and models
(`portbench/configs/`; the dataset is generated into `portbench/.cache/`
on a checkout's first run), and at these shapes each timed kernel's output
is also held to its plain version, which a mismatch stops:

  * spmm_csr: y = A @ x at d 64 on CIKM_Model's ui and ri graphs (the main
    path: one eval_cache takes 1 ui and 2 ri hops), on SCHGN's directed
    graph and on a power-law user-item graph of Foodcom's size; bf16 mode
    beside it
  * spmm_csr_bwd: the same kernel on A^T, the gradient of each product
    (SCHGN's A^T cuts one row a calorie level, through the fix-up kernel)
  * by_user_metrics: one 256 x 640 block of users, 8-16 positives a user
  * gather_rows_bwd: the table gradient of [1024, 20] ingredient codes
    into 4,964 x 64 (CIKM_Model) and of [512, 20] into 4,965 x 64 (SCHGN),
    beside the stable sort its ids take once

The bars: the SpMM, forward and backward in float32 and in bf16 mode,
max|y - plain| <= 1e-5 * max|y| + 1e-6; by_user_metrics bit for bit;
gather_rows_bwd within 1e-6 * max|g| * sqrt(the longest run of one id).

A time is the median device time of a launch, by CUDA events, with the L2
cache flushed before each (a 256 MB read), and the mean of launches queued
back to back with the L2 warm; bounds come from portbench/peaks.py. Each
kernel's launches are counted over one call of the main path; a training
step's on a step that replays the loss block's CUDA graphs, the kernels
inside them by name from a device trace of it. The line
before the last is the kernels' JSON record; the last line is {"ok": true,
"device": {...}}. The kernels build into build/kernels/ (gitignored).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from portbench import peaks

SEED = 999
QUEUE_CYCLES = 2_000_000  # ~1 ms of device clock cycles
# the benchmark's configurations whose models give the graphs and the
# launch counts
CIKM_CONFIG, SCHGN_CONFIG = "cikm-foodcom", "schgn-foodcom"
# a power-law user-item graph at Foodcom's sizes: (users, items, draws)
POWER_LAW = (7596, 29943, 192_000)
METRIC_BLOCK, METRIC_NEG = (256, 640), 500
# the gather backward's cases: (ids' shape, table rows); the ingredients'
# table has a pad row (CIKM_Model) and a mask row (SCHGN)
N_INGREDIENTS = 4963
GATHER_CASES = {"CIKM_Model [1024, 20]": ((1024, 20), N_INGREDIENTS + 1),
                "SCHGN [512, 20]": ((512, 20), N_INGREDIENTS + 2)}
# the hand-written kernels that a replayed loss block launches, by the
# names a device trace gives them: gather_rows_bwd's two passes
GRAPH_KERNELS = ("gather_bwd_tiles", "gather_bwd_rows")


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, flush, reps=50, warmup=5):
    """Median device time of fn() in ms: CUDA events around each call, the
    L2 cache flushed before each by reading a 256 MB buffer. A device-side
    wait after the flush holds the start event back until the host has
    queued fn's launches, so the host's time to issue them is not counted
    as device time."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def warm_time_ms(fn, reps=50, warmup=5):
    """(device ms, host ms) a call of fn() with no flush: CUDA events around
    `reps` calls queued back to back behind a device-side wait long enough
    for the host to queue them all, and the host's time to queue one."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda._sleep(QUEUE_CYCLES * reps // 4)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def times(fn, flush, reps=50):
    """{ms, warm_ms, host_ms} of fn()."""
    ms = cuda_time_ms(fn, flush, reps=reps)
    warm_ms, host_ms = warm_time_ms(fn, reps=reps)
    return dict(ms=ms, warm_ms=warm_ms, host_ms=host_ms)


def device(torch):
    """The card's name and power limit; TF32 off, as in the port's runs."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability()
    log(f"[device] {card}; capability {cap}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"expected compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build(kernels):
    """Every kernel from the checkout's sources, with ptxas's report."""
    t0 = time.perf_counter()
    for name, out in kernels.build(ptxas_verbose=True).items():
        for line in out.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")
    kernels.load_all()
    log(f"[build] {sorted(kernels.KERNELS)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")


def launches_of(torch, kernels, fn):
    """{kernel: launches} of one call of fn()."""
    before = dict(kernels.launches)
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in kernels.launches.items()
            if v != before[k]}


def step_launches(torch, kernels, trainer, batch):
    """(capture, replay): {kernel: launches} of a model's first training
    step on the main path, which captures its loss block as CUDA graphs
    (`kernels.launches`: the warm-up's and the capture's), and of the next,
    which replays them. A replay launches the block's kernels as graph
    nodes, which `kernels.launches` does not see: the replayed step gives
    `kernels.launches` of what stays eager (the SpMM) and, by kernel name
    from a device trace, where a graph's nodes appear one by one, each
    kernel of GRAPH_KERNELS."""
    import tempfile

    from foodrec_tpu_torch.common import step_graph
    from portbench.trace import Trace

    def step():
        trainer.train_steps([batch])

    captures = step_graph.captures
    capture = launches_of(torch, kernels, step)
    if step_graph.captures != captures + 1:
        raise AssertionError("the first training step captured "
                             f"{step_graph.captures - captures} graphs, not 1")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        replay = launches_of(torch, kernels, step)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        names = [d[2] for d in Trace.load(path).device]
    if step_graph.captures != captures + 1 or "gather_rows_bwd" in replay:
        raise AssertionError("the second training step did not replay the "
                             "captured loss block")
    for k in GRAPH_KERNELS:
        replay[k] = sum(k in n for n in names)
    return capture, replay


def close(name, got, want, bar):
    """max|got - want|, which must be within `bar`."""
    err = float((got - want).abs().max())
    if not err <= bar:
        raise AssertionError(f"{name}: max|kernel - plain| {err:.3e} above "
                             f"{bar:.3e}")
    return err


def spmm_bar(y):
    return 1e-5 * float(y.abs().max()) + 1e-6


def program(config_name):
    """(cfg, FoodData, model) of a benchmark configuration on the card: its
    dataset, and the model's own initial weights from SEED."""
    import torch
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model
    from portbench import harness

    c = harness.load_yaml(os.path.join(harness.PKG, "configs",
                                       config_name + ".yaml"))
    name = c["data"]["name"]
    cfg = Config(c["model"], name, {
        **c["model_config"], "data_path": harness.dataset(c) + "/",
        "seed": SEED, "use_gpu": True})
    derive_data_paths(cfg, name)
    fd = FoodData(cfg)
    fd.device_data = DeviceData.from_food_data(fd)
    return cfg, fd, get_model(c["model"])(
        cfg, fd, torch.Generator().manual_seed(SEED))


def train_batch(torch, dd, seed):
    """One training batch of 512 (users, positives, uniform negatives)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(dd.train_u), 512, replace=False)
    return tuple(torch.as_tensor(a).cuda().long() for a in (
        dd.train_u[pick], dd.train_i[pick],
        rng.integers(0, dd.n_items, 512)))


def zipf_adjacency(n_users, n_items, n_edges, seed=0):
    """A power-law bipartite user-item graph, symmetric-normalized: uniform
    users, Zipf-0.8 item popularity (the JAX package's SpMM microbench
    graph, tools/spmm_microbench.py:23-34)."""
    from foodrec_tpu_torch.ops.graph import sym_normalized_adjacency

    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    u = rng.integers(0, n_users, n_edges)
    i = rng.choice(n_items, size=n_edges, p=pop / pop.sum()) + n_users
    return sym_normalized_adjacency(u, i, n_users + n_items)


def spmm_graph(torch, spmm, prop, flush, rng):
    """The forward and the backward (on A^T) of one graph at d 64: the
    kernel (and its bf16 mode) held to the plain `segment` path and timed
    beside it, torch.sparse.mm and the byte bound."""
    adj = prop.adj
    n, nnz, d = adj.n_nodes, adj.nnz, 64
    x, g = (torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).cuda() for _ in "xg")
    segment = spmm.Propagator(adj, impl="segment", device="cuda")
    bf16 = spmm.Propagator(adj, impl="kernel", compute_dtype="bfloat16",
                           device="cuda")
    a, a_t = prop.csr(), prop.csr(transpose=True)
    lib_a, lib_at = (torch.sparse_csr_tensor(*m[:3], size=(n, n),
                                             check_invariants=True)
                     for m in (a, a_t))
    xr = x.clone().requires_grad_(True)
    y_seg = segment(xr)

    def rounded(t):
        return t.bfloat16().float()

    fwd_err, bwd_err = [], []
    for mode, run, x_in, cot in (("f32", prop, x, g),
                                 ("bf16", bf16, rounded(x), rounded(g))):
        with torch.no_grad():
            want = segment(x_in)
            fwd_err.append(close(f"spmm_csr {mode}", run(x), want,
                                 spmm_bar(want)))
        want, = torch.autograd.grad(y_seg, xr, cot, retain_graph=True)
        bwd_err.append(close(f"spmm_csr_bwd {mode}", spmm.spmm_csr(
            *a_t, g, count="spmm_csr_bwd", round_bf16=mode == "bf16"),
            want, spmm_bar(want)))
    bound = dict(bound_ms=peaks.spmm_least_seconds(n, nnz, d) * 1e3,
                 bytes=peaks.spmm_bytes(n, nnz, d),
                 bound_by="bytes" if peaks.spmm_bytes(n, nnz, d)
                 / peaks.HBM_BYTES_PER_S >= 2 * nnz * d
                 / peaks.FP32_FLOPS_PER_S else "operations")
    shape = dict(n=n, nnz=nnz, d=d, max_degree=adj.max_degree,
                 symmetric=adj.symmetric)
    with torch.no_grad():
        fwd = dict(
            shape, **times(lambda: prop(x), flush),
            bf16_ms=cuda_time_ms(lambda: bf16(x), flush),
            plain_ms=cuda_time_ms(lambda: segment(x), flush),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(lib_a, x), flush),
            items=prop.plan.n_items, cut_rows=prop.plan.n_fix,
            max_err=fwd_err, **bound)
    plan_t = prop.t_plan if not adj.symmetric else prop.plan
    bwd = dict(
        shape, **times(lambda: spmm.spmm_csr(*a_t, g, count="spmm_csr_bwd"),
                       flush),
        bf16_ms=cuda_time_ms(lambda: spmm.spmm_csr(
            *a_t, g, count="spmm_csr_bwd", round_bf16=True), flush),
        plain_ms=cuda_time_ms(lambda: torch.autograd.grad(
            y_seg, xr, g, retain_graph=True), flush),
        library_ms=cuda_time_ms(lambda: torch.sparse.mm(lib_at, g), flush),
        items=plan_t.n_items, cut_rows=plan_t.n_fix, max_err=bwd_err,
        **bound)
    return fwd, bwd


def log_spmm(direction, name, t):
    log(f"[spmm_csr{direction}] {name}: n={t['n']} nnz={t['nnz']} d={t['d']}"
        f" max_deg={t['max_degree']} items={t['items']} cut_rows="
        f"{t['cut_rows']}: kernel {t['ms'] * 1e3:.2f} us clean flush, "
        f"{t['warm_ms'] * 1e3:.2f} us warm (host {t['host_ms'] * 1e3:.1f} us"
        f" a call), bf16 mode {t['bf16_ms'] * 1e3:.2f} us; plain "
        f"{t['plain_ms'] * 1e3:.2f} us; torch.sparse.mm "
        f"{t['library_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.2f} us"
        f" ({t['bound_ms'] / t['ms']:.3f} of it); max|kernel - plain| f32 "
        f"{t['max_err'][0]:.3e}, bf16 {t['max_err'][1]:.3e}")


def spmm_entries(torch, kernels, spmm, cikm, schgn, flush):
    """The SpMM's forward and backward entries: times summed over the
    products of CIKM_Model's main path (1 ui + 2 ri hops), every graph's
    own under `per_graph`; launches counted over one eval_cache and one
    replayed training step of CIKM_Model."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    (cfg, fd, model), (_, _, schgn_model) = cikm, schgn
    hops = {"CIKM_Model.ui_prop": model.ui_layers,
            "CIKM_Model.ri_prop": model.n_layers}
    props = {"CIKM_Model.ui_prop": model.ui_prop,
             "CIKM_Model.ri_prop": model.ri_prop,
             "SCHGN.gcn_prop": schgn_model.gcn_prop,
             "power-law foodcom": spmm.Propagator(
                 zipf_adjacency(*POWER_LAW), impl="kernel", device="cuda")}
    if {p.impl for p in props.values()} != {"kernel"}:
        raise AssertionError(f"{ {k: p.impl for k, p in props.items()} }")
    rng = np.random.default_rng(SEED)
    fwd, bwd = {}, {}
    for name, prop in props.items():
        fwd[name], bwd[name] = spmm_graph(torch, spmm, prop, flush, rng)
        log_spmm("", name, fwd[name])
        log_spmm("_bwd", name, bwd[name])
    with torch.no_grad():
        serve = launches_of(torch, kernels, model.eval_cache)
    capture, step = step_launches(torch, kernels, Trainer(cfg, model),
                                  train_batch(torch, fd.device_data, SEED))
    log(f"[launches] one CIKM_Model eval_cache {serve}; one training step "
        f"{step} (the step that captured its loss block {capture})")

    def entry(per_graph, **fields):
        return {"route": "cuda",
                "source": "foodrec_tpu_torch/csrc/spmm_csr.cu", **fields,
                **{k: sum(per_graph[g][k] * h for g, h in hops.items())
                   for k in ("ms", "warm_ms", "bound_ms", "plain_ms",
                             "library_ms")},
                "bound_by": per_graph["CIKM_Model.ri_prop"]["bound_by"],
                "per_graph": per_graph}

    return step, [
        entry(fwd, name="spmm_csr", replaces="foodrec_tpu/ops/spmm.py:129",
              per="one CIKM_Model eval_cache: 2 ri_prop hops + 1 ui_prop hop",
              launches=serve["spmm_csr"]),
        entry(bwd, name="spmm_csr_bwd",
              replaces="foodrec_tpu/ops/spmm.py:129 (custom VJP :263-273)",
              per="one replayed CIKM_Model training step: 2 ri_prop + 1 "
                  "ui_prop backward hops", launches=step["spmm_csr_bwd"])]


def metrics_entry(torch, kernels, cikm, flush):
    """by_user_metrics at the main path's block: 256 users x 640 slots, the
    8-16 positives of a Foodcom test user and ~500 negatives; launches
    counted over one evaluate(test) pass of CIKM_Model."""
    from foodrec_tpu_torch.engine import evaluator
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, fd, model = cikm
    rng = np.random.default_rng(SEED)
    b, c = METRIC_BLOCK
    n_pos = rng.integers(8, 17, b)
    s, p, n = (torch.from_numpy(a).cuda() for a in (
        rng.standard_normal((b, c)).astype(np.float32), n_pos,
        n_pos + METRIC_NEG - rng.integers(0, 4, b)))
    got, want = (f(s, p, n, METRIC_NEG) for f in (
        evaluator.by_user_metrics, evaluator.by_user_metrics_plain))
    for k, v in want.items():  # bit for bit
        if not torch.equal(got[k].view(torch.int32), v.view(torch.int32)):
            raise AssertionError(f"by_user_metrics {k}: the kernel is not "
                                 f"the plain path bit for bit")
    kernel = times(lambda: evaluator.by_user_metrics(s, p, n, METRIC_NEG),
                   flush)
    plain = times(lambda: evaluator.by_user_metrics_plain(s, p, n,
                                                          METRIC_NEG),
                  flush, reps=20)
    bound_ms = s.numel() * 4 / peaks.HBM_BYTES_PER_S * 1e3
    trainer = Trainer(cfg, model)
    launches = launches_of(torch, kernels, lambda: trainer.evaluate(
        fd.device_data.eval_test, is_test=True))
    log(f"[by_user_metrics] {b} x {c}: kernel {kernel['ms'] * 1e3:.2f} us "
        f"clean flush, {kernel['warm_ms'] * 1e3:.2f} us warm (host "
        f"{kernel['host_ms'] * 1e3:.1f} us a call); plain "
        f"{plain['ms'] * 1e3:.1f} us clean flush, "
        f"{plain['warm_ms'] * 1e3:.1f} us warm (host "
        f"{plain['host_ms'] * 1e3:.1f} us a call); bound "
        f"{bound_ms * 1e3:.3f} us; one evaluate(test) pass {launches}; "
        f"bit for bit the plain path")
    return {"name": "by_user_metrics", "route": "cuda",
            "source": "foodrec_tpu_torch/csrc/by_user_metrics.cu",
            "replaces": "none (foodrec_tpu/engine/evaluator.py:30 "
                        "by_user_metrics, jnp)",
            "per": "one by-user block of 256 users x 640 slots; launches: "
                   "one CIKM_Model evaluate(test) pass",
            **kernel, "plain_ms": plain["ms"],
            "plain_warm_ms": plain["warm_ms"],
            "plain_host_ms": plain["host_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "launches": launches["by_user_metrics"], "block": [b, c]}


def gather_ids(rng, shape):
    """Ingredient codes as the dataset holds them: 1-6 real codes a recipe,
    the other slots the pad id (~82% of them)."""
    ids = np.full(shape, N_INGREDIENTS, np.int64)
    for i, k in enumerate(rng.integers(1, 7, shape[0])):
        ids[i, :k] = rng.choice(N_INGREDIENTS, size=k, replace=False)
    return ids


def gather_entry(torch, kernels, cikm_step, schgn, flush):
    """gather_rows_bwd at the two models' shapes beside its sort, its plain
    version and PyTorch's index_put_(accumulate=True), what table[idx]'s
    backward runs; the entry's times are CIKM_Model's case, its launches
    those of one replayed training step of CIKM_Model, and of SCHGN beside
    them."""
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.ops.gather import RowIds, gather_rows_backward_plain

    cfg, fd, model = schgn
    schgn_capture, schgn_step = step_launches(
        torch, kernels, Trainer(cfg, model),
        train_batch(torch, fd.device_data, SEED))
    rng = np.random.default_rng(SEED + 3)
    cases = {}
    for name, (shape, n_rows) in GATHER_CASES.items():
        ids = torch.from_numpy(gather_ids(rng, shape)).cuda()
        g = torch.randn(ids.numel(), 64, device="cuda")
        sid, order = RowIds(ids).plan()
        flat = ids.reshape(-1)
        err = close(f"gather_rows_bwd {name}", kernels.gather_rows_bwd(
            g, sid, order, n_rows).double(), gather_rows_backward_plain(
                g.double(), ids, n_rows), 1e-6 * float(g.abs().max())
            * float(torch.bincount(flat).max()) ** 0.5)
        moved = g.numel() * 4 + flat.numel() * 8 + n_rows * 64 * 4
        t = cases[name] = dict(
            ids=list(shape), rows=n_rows,
            **times(lambda: kernels.gather_rows_bwd(g, sid, order, n_rows),
                    flush),
            sort_ms=cuda_time_ms(lambda: RowIds(ids).plan(), flush),
            plain_ms=cuda_time_ms(lambda: gather_rows_backward_plain(
                g, ids, n_rows), flush, reps=20),
            library_ms=cuda_time_ms(lambda: torch.zeros(
                n_rows, 64, device="cuda").index_put_((flat,), g,
                                                       accumulate=True),
                flush, reps=20),
            bound_ms=moved / peaks.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            max_err=err)
        log(f"[gather_rows_bwd] {name} into {n_rows} x 64: kernel "
            f"{t['ms'] * 1e3:.2f} us clean flush, {t['warm_ms'] * 1e3:.2f} "
            f"us warm (host {t['host_ms'] * 1e3:.1f} us a call); sort "
            f"{t['sort_ms'] * 1e3:.2f} us; plain {t['plain_ms'] * 1e3:.1f} "
            f"us; index_put_ {t['library_ms'] * 1e3:.1f} us; bound "
            f"({moved / 1e6:.2f} MB) {t['bound_ms'] * 1e3:.2f} us; "
            f"max|kernel - plain| {err:.3e}")
    steps = {"CIKM_Model": cikm_step["gather_bwd_tiles"],
             "SCHGN": schgn_step["gather_bwd_tiles"]}
    for name, st in (("CIKM_Model", cikm_step), ("SCHGN", schgn_step)):
        if st["gather_bwd_rows"] != st["gather_bwd_tiles"]:
            raise AssertionError(f"{name}'s replayed step: gather_bwd_tiles "
                                 f"and gather_bwd_rows launch unequally {st}")
    log(f"[launches] gather_rows_bwd a replayed training step: {steps}; "
        f"one SCHGN step {schgn_step} (the step that captured its loss "
        f"block {schgn_capture})")
    main = cases["CIKM_Model [1024, 20]"]
    return {"name": "gather_rows_bwd", "route": "cuda",
            "source": "foodrec_tpu_torch/csrc/gather_rows_bwd.cu",
            "replaces": "none (the JAX package's gathers go to XLA)",
            "per": "one gather's backward at CIKM_Model's [1024, 20] (the "
                   "sort is per id tensor); launches: one replayed "
                   "CIKM_Model training step",
            **{k: main[k] for k in ("ms", "warm_ms", "host_ms", "sort_ms",
                                    "bound_ms", "bound_by", "plain_ms",
                                    "library_ms")},
            "launches": steps["CIKM_Model"], "launches_a_step": steps,
            "cases": cases}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from foodrec_tpu_torch.ops import _kernels, spmm

    card = device(torch)
    build(_kernels)
    t0 = time.perf_counter()
    cikm, schgn = program(CIKM_CONFIG), program(SCHGN_CONFIG)
    log(f"[setup] the benchmark's dataset and both models in "
        f"{time.perf_counter() - t0:.1f} s")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    cikm_step, spmm_kernels = spmm_entries(torch, _kernels, spmm, cikm,
                                           schgn, flush)
    record = {"kernels": [*spmm_kernels,
                          metrics_entry(torch, _kernels, cikm, flush),
                          gather_entry(torch, _kernels, cikm_step, schgn,
                                       flush)]}
    log(card)  # again beside the results, for a reader of the output's end
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
