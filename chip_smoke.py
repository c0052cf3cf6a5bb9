#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`foodrec_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels

Drives the port's serving and training paths for CIKM_Model at full width
(embedding 64, 2 recipe-ingredient hops + 1 user-item hop, a 2-layer post-LN
encoder with 2 heads, both target attentions, the health MLP, trainable
2048-d image and 512-d text tables; batch 512, dropout 0.5, Adam lr 0.002)
on the Foodcom-scale synthetic catalog (7,596 users x 29,943 items x 4,963
ingredients), with random weights from seed 999:

  1. device: card name and power limit, compute capability 9.0, TF32 off
  2. build: every CUDA kernel from the sources in the checkout
  3. each kernel against its plain PyTorch version, in f32 and in bf16 mode,
     on random graphs (hub row, empty rows, odd n, nnz = 0; d in {16, 64,
     96}) and on two power-law graphs (Zipf item popularity at Foodcom's and
     Allrecipes' user-item sizes), forward and backward, run to run bitwise
  4. serving: dataset -> Config/FoodData/DeviceData -> CIKM_Model on cuda;
     kernel against plain on both real adjacencies; eval_cache through the
     kernel and through `segment`; Trainer.evaluate on valid and test;
     full_sort_topk for 64 users against the plain path; launch counts
  5. times: CUDA events, L2 flushed before each launch (clean and dirty),
     medians, and back to back with the L2 warm; what an empty launch and a
     copy of the same bytes read under the same clock; the kernel at other
     plan geometries
  6. training: the SpMM gradient (SpmmCSR: the kernel on A^T) against
     `segment` autograd on random graphs (one symmetric, one row-normalized)
     and both real adjacencies, run to run bitwise; one calculate_loss
     gradient and 20 Adam steps through the kernel and through `segment`;
     one full epoch (Trainer.train_epoch) with 3 forward + 3 backward
     launches a step; evaluate(valid); the epoch's time, a profile of 20
     steps, peak memory, and the backward launch's time

Any failed check raises and the script exits non-zero. The line before the
last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. The kernel build lands in build/kernels/ and
the dataset in build/smoke_data/, both gitignored.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_ROOT = os.path.join(ROOT, "build", "smoke_data")
DATASET = "FoodcomSynth"
# the Foodcom-scale synthetic of the JAX package's bench (bench.py:27-32)
FOODCOM_SCALE = dict(
    n_users=7596, n_items=29943, n_ingredients=4963, n_cal_levels=60,
    n_health_levels=6, n_clusters=2000, img_dim=2048, txt_dim=512,
    neg_num=500, train_per_user=(20, 31), valid_per_user=(2, 7),
    test_per_user=(8, 17), seed=7,
)
SEED = 999
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# power-law graphs of the JAX package's microbench generator (zipf_adjacency):
# (users, items, draws) at Foodcom's and at Allrecipes' user-item sizes
# (foodrec_tpu/ops/spmm.py:59-62)
POWER_LAW = {"foodcom_zipf": (7596, 29943, 192_000),
             "allrecipes_zipf": (68768, 45630, 677_000)}
TOPK_USERS, TOPK_K = 64, 50
QUEUE_CYCLES = 2_000_000  # ~1 ms of device clock cycles (cuda_time_ms)
COMPARE_STEPS = 20    # Adam steps through each SpMM path (phase 6)
PROFILE_STEPS = 20
LOSS_WINDOW = 50      # the loss must fall from the first to the last steps
# Two float32 Adam trajectories that differ only in rounding part: an
# element whose gradient is near Adam's eps moves by up to lr * dg / eps for
# a gradient difference dg, and the key part of the encoder's in_proj bias
# has a gradient that is zero in exact arithmetic, so its rounding noise
# takes steps of +-lr with a random sign. The BPR part (mf), which reads the
# propagated embeddings the kernel computes, keeps the bar of 1e-4 over the
# 20 steps; the health, KD and reg parts, which read the encoder and the raw
# tables, part by a few per cent (4.4e-2 for reg at step 19 on an H100
# 80GB HBM3 at 700 W), so their bar is 0.2. The gradients themselves are
# held to `bar` at every step from the same parameters.
TRAJECTORY_TOL = np.array([1e-4, 0.2, 0.2, 0.2])  # mf, health, kd, reg


def log(msg):
    print(msg, flush=True)


def bar(y_ref):
    """The kernel-vs-plain bar of the JAX package's bench (bench.py:106)."""
    return 1e-5 * float(y_ref.abs().max()) + 1e-6


def check_close(name, y, y_ref):
    err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    tol = bar(y_ref) if y.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max|d|={err:.3e} > bar {tol:.3e}")
    return err


def cuda_time_ms(fn, flush, reps=50, warmup=5, dirty=False):
    """Median device time of fn() in ms: CUDA events around each call, with
    the L2 cache flushed before each by reading a 256 MB buffer, which
    leaves the L2 holding clean lines. `dirty=True` flushes by writing the
    buffer instead (the earlier method): the L2 is then full of dirty lines,
    and fn's misses pay for writing them back. A device-side wait of
    QUEUE_CYCLES after the flush holds the start event back until the host
    has queued fn's launches, so the host's time to issue them (tens of us
    of Python for an autograd Function, more on a busy host) is not
    counted as device time."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
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
    """(device ms, host ms) per call of fn() with no flush: CUDA events
    around `reps` calls queued back to back, behind a device-side wait long
    enough for the host to queue them all (QUEUE_CYCLES / 4 a call, some
    280 us), over reps; and the host's time to queue one call. The inputs
    stay in the L2 from one call to the next, as a propagation hop finds the
    x that the step just computed."""
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


def phase_floor(torch):
    """What the timing itself costs: an empty launch, and a device copy that
    moves as many bytes as the SpMM on ui_prop must (22.4 MB), under the
    clean flush and warm."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    src = torch.randn(2_802_000, device="cuda")  # 11.2 MB in, 11.2 MB out
    dst = torch.empty_like(src)
    empty = cuda_time_ms(lambda: torch.cuda._sleep(0), flush)
    copy = cuda_time_ms(lambda: dst.copy_(src), flush)
    copy_warm, _ = warm_time_ms(lambda: dst.copy_(src))
    bound = 2 * src.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[5 floor] empty launch {empty * 1e3:.2f} us; copy of "
        f"{2 * src.numel() * 4 / 1e6:.1f} MB {copy * 1e3:.2f} us clean flush, "
        f"{copy_warm * 1e3:.2f} us warm, bound {bound * 1e3:.2f} us")
    return dict(empty_launch_ms=empty, copy_ms=copy, copy_warm_ms=copy_warm,
                copy_bound_ms=bound)


def random_csr(rng, n, n_cols, avg_degree=8, empty_frac=0.2, hub_degree=0):
    deg = rng.poisson(avg_degree, n)
    deg[rng.random(n) < empty_frac] = 0
    if hub_degree:
        deg[n // 2] = hub_degree
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = rng.integers(0, n_cols, row_ptr[-1]).astype(np.int32)
    vals = rng.standard_normal(row_ptr[-1]).astype(np.float32)
    return row_ptr, cols, vals


def zipf_adjacency(n_users, n_items, n_edges, seed=0):
    """A power-law bipartite user-item graph, symmetric-normalized: uniform
    users, Zipf-0.8 item popularity. A copy of the JAX package's SpMM
    microbench graph (tools/spmm_microbench.py:23-34) on the port's
    builder."""
    from foodrec_tpu_torch.ops.graph import sym_normalized_adjacency

    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    pop /= pop.sum()
    u = rng.integers(0, n_users, n_edges)
    i = rng.choice(n_items, size=n_edges, p=pop) + n_users
    return sym_normalized_adjacency(u, i, n_users + n_items)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    cap = torch.cuda.get_device_capability()
    log(f"[1 device] {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"expected compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def phase_build(kernels):
    t0 = time.perf_counter()
    logs = kernels.build(ptxas_verbose=True)
    for name, out in logs.items():
        for line in out.strip().splitlines():
            log(f"[2 build] {name}: {line.strip()}")
    kernels.load_all()
    log(f"[2 build] kernels {sorted(kernels.KERNELS)} built and loaded "
        f"in {time.perf_counter() - t0:.1f} s")


def bf16_round(x):
    """x rounded to bf16 (to nearest even) and back: the kernel's bf16 mode
    reads its input so."""
    return x.bfloat16().float()


def kernel_vs_plain(torch, kernels, spmm, name, csr, x):
    """The kernel on A = csr (row_ptr, cols, vals, plan) against
    `spmm_csr_plain`, in f32 and in bf16 mode (plain on x rounded to bf16),
    each run twice and bitwise equal. Returns the two errors."""
    errs = []
    for bf16 in (False, True):
        y1, y2 = (kernels.spmm_csr(*csr, x, round_bf16=bf16) for _ in "12")
        y_plain = spmm.spmm_csr_plain(*csr[:3], bf16_round(x) if bf16 else x)
        torch.cuda.synchronize()
        errs.append(check_close(f"{name} bf16={bf16}", y1, y_plain))
        if not torch.equal(y1, y2):
            raise AssertionError(f"{name} bf16={bf16}: two kernel runs differ")
    return errs


def device_csr(torch, spmm, row_ptr, cols, vals):
    """(row_ptr, cols, vals, plan) on the card from host arrays."""
    plan = spmm.plan_csr(row_ptr)
    return tuple(torch.from_numpy(a).cuda() for a in (row_ptr, cols, vals)) + (
        plan.with_table(torch.from_numpy(plan.table).cuda()),)


def phase_random_graphs(torch, kernels, spmm):
    rng = np.random.default_rng(SEED)
    cases = [
        ("hub+empty d64", 10_001, 64, dict(hub_degree=6000)),
        ("hub+empty d16", 10_001, 16, dict(hub_degree=6000)),
        ("odd n d96", 4_097, 96, dict(hub_degree=700)),
        ("nnz=0 d64", 1_000, 64, dict(avg_degree=0)),
        ("empty stretch d64", 3_001, 64, dict(avg_degree=3, empty_frac=0.9)),
    ]
    for name, n, d, kw in cases:
        csr = device_csr(torch, spmm, *random_csr(rng, n, n, **kw))
        x = torch.from_numpy(
            rng.standard_normal((n, d)).astype(np.float32)).cuda()
        errs = kernel_vs_plain(torch, kernels, spmm, name, csr, x)
        deg = (csr[0][1:] - csr[0][:-1])
        log(f"[3 random] {name}: n={n} nnz={csr[1].numel()} "
            f"max_deg={int(deg.max())} empty_rows={int((deg == 0).sum())} "
            f"items={csr[3].n_items} cut_rows={csr[3].n_fix} max|d| f32 "
            f"{errs[0]:.3e} bf16 {errs[1]:.3e} bitwise-repeat=ok")


def phase_power_law(torch, kernels, spmm):
    """The kernel on the two power-law graphs at d 64: forward against
    `spmm_csr_plain` and the gradient (SpmmCSR) against `segment` autograd,
    in f32 and bf16 mode, two runs of each bitwise equal. Returns the graphs
    for the timed phases."""
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    graphs = {}
    for name, (n_users, n_items, n_edges) in POWER_LAW.items():
        adj = zipf_adjacency(n_users, n_items, n_edges)
        prop = spmm.Propagator(adj, impl="kernel", device=dev)
        segment = spmm.Propagator(adj, impl="segment", device=dev)
        x = torch.from_numpy(rng.standard_normal(
            (adj.n_nodes, 64)).astype(np.float32)).to(dev)
        errs = kernel_vs_plain(torch, kernels, spmm, name, prop.csr(), x)
        deg = np.diff(adj.row_ptr)
        hub = deg > 256
        log(f"[3 power-law] {name}: n={adj.n_nodes} nnz={adj.nnz} "
            f"max_deg={int(deg.max())} p99_deg={np.percentile(deg, 99):.0f} "
            f"rows>256={int(hub.sum())} ({deg[hub].sum() / adj.nnz:.3f} of "
            f"nnz) empty_rows={int((deg == 0).sum())} items="
            f"{prop.plan.n_items} cut_rows={prop.plan.n_fix} kernel vs plain "
            f"max|d| f32 {errs[0]:.3e} bf16 {errs[1]:.3e} bitwise-repeat=ok")
        grad_err = spmm_grad_check(torch, spmm, name, adj, 64, rng,
                                   kernel=prop, segment=segment,
                                   tag="3 power-law")
        graphs[name] = dict(prop=prop, segment=segment, x=x, err=max(errs),
                            grad_err=grad_err, main_path=False)
    return graphs


def swap_propagators(model, impl):
    """Replace both propagators by `impl` ones over the same adjacencies;
    returns the previous pair."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    old = model.ui_prop, model.ri_prop
    model.ui_prop = Propagator(old[0].adj, impl=impl, device=model.device)
    model.ri_prop = Propagator(old[1].adj, impl=impl, device=model.device)
    return old


def phase_serving(torch, kernels, spmm):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    t0 = time.perf_counter()
    base = os.path.join(DATA_ROOT, DATASET)
    if not os.path.isfile(os.path.join(base, "processed_dataset",
                                       "_GEN_COMPLETE")):
        synthetic.generate(base, **FOODCOM_SCALE)
        log(f"[4 serve] generated {DATASET} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = Config("CIKM_Model", DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED,
        "neg_sample_num": FOODCOM_SCALE["neg_num"]})
    derive_data_paths(cfg, DATASET)
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = get_model("CIKM_Model")(
        cfg, data, generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[4 serve] device={cfg['device']} users={dd.n_users} "
        f"items={dd.n_items} ingredients={dd.n_ingredients} "
        f"embedding={cfg['embedding_size']} n_layers={model.n_layers} "
        f"ui_layers={model.ui_layers}; load {t_load:.1f} s, "
        f"model {time.perf_counter() - t0:.1f} s")
    impls = (model.ui_prop.impl, model.ri_prop.impl)
    log(f"[4 serve] ui_prop.impl={impls[0]} ri_prop.impl={impls[1]}")
    if impls != ("kernel", "kernel"):
        raise AssertionError(f"auto picked {impls}, expected the kernel")

    # kernel against plain on both real adjacencies, at the path's width
    rng = np.random.default_rng(SEED)
    graphs = {}
    for name, prop, hops in (("ui_prop", model.ui_prop, model.ui_layers),
                             ("ri_prop", model.ri_prop, model.n_layers)):
        adj = prop.adj
        x = torch.from_numpy(rng.standard_normal(
            (adj.n_nodes, cfg["embedding_size"])).astype(np.float32)).cuda()
        with torch.no_grad():
            y = prop(x)
            y_again = prop(x)
        segment = spmm.Propagator(adj, impl="segment", device=model.device)
        y_plain = segment(x)
        err = check_close(name, y, y_plain)
        if adj.has_ell:
            err = max(err, check_close(
                name, y, spmm.Propagator(adj, impl="ell",
                                         device=model.device)(x)))
        if not torch.equal(y, y_again):
            raise AssertionError(f"{name}: two kernel runs differ")
        err, err_bf16 = kernel_vs_plain(torch, kernels, spmm, name,
                                        prop.csr(), x)
        graphs[name] = dict(prop=prop, segment=segment, x=x,
                            err=max(err, err_bf16), hops=hops)
        log(f"[4 serve] {name}: n={adj.n_nodes} nnz={adj.nnz} "
            f"max_deg={adj.max_degree} items={prop.plan.n_items} cut_rows="
            f"{prop.plan.n_fix} kernel vs plain max|d| f32 {err:.3e} bf16 "
            f"{err_bf16:.3e} bar={bar(y_plain):.3e} bitwise-repeat=ok")

    # eval_cache through the kernel and through segment
    user_k, item_k = model.eval_cache()
    kernel_props = swap_propagators(model, "segment")
    user_p, item_p = model.eval_cache()
    model.ui_prop, model.ri_prop = kernel_props
    emb_err = max(check_close("eval_cache users", user_k, user_p),
                  check_close("eval_cache items", item_k, item_p))
    log(f"[4 serve] eval_cache kernel vs segment max|d|={emb_err:.3e}")

    # the main path, counted: by-user eval on valid and test, top-k requests
    trainer = Trainer(cfg, model)
    kernels.launches["spmm_csr"] = 0
    n_caches = 0
    results = {}
    for split, es in (("valid", dd.eval_valid), ("test", dd.eval_test)):
        t0 = time.perf_counter()
        metrics = trainer.evaluate(es, is_test=split == "test")
        secs = time.perf_counter() - t0
        n_caches += 1
        results[split] = metrics
        vals = np.array(list(metrics.values()))
        if not (np.isfinite(vals).all() and (vals >= 0).all()
                and (vals <= 1).all()):
            raise AssertionError(f"{split} metrics out of range: {metrics}")
        log(f"[4 serve] evaluate({split}): {json.dumps(metrics)} "
            f"users={es.n_users} {secs:.3f} s {es.n_users / secs:.0f} users/s")
    users = np.arange(TOPK_USERS)
    with torch.no_grad():
        cache = model.eval_cache()
        n_caches += 1
        top = full_sort_topk(
            lambda u, i: model.score_items(cache, u, i), users,
            dd.n_items, TOPK_K, device=model.device)
    launches = kernels.launches["spmm_csr"]
    log(f"[4 serve] main path: {launches} spmm_csr launches over {n_caches} "
        f"eval_cache calls")
    hops = model.n_layers + model.ui_layers  # 2 ri hops + 1 ui hop
    if launches != hops * n_caches:
        raise AssertionError(
            f"expected {hops * n_caches} launches, got {launches}")

    # top-k against the plain path: equal up to swaps of near-equal scores
    with torch.no_grad():
        top_plain = full_sort_topk(
            lambda u, i: user_p[u] @ item_p[i].T, users, dd.n_items, TOPK_K,
            device=model.device)
        scores = (user_p[torch.as_tensor(users).cuda()] @ item_p.T).cpu()
    if top.shape != (TOPK_USERS, TOPK_K):
        raise AssertionError(f"top-k shape {tuple(top.shape)}")
    gap = (scores.gather(1, top) - scores.gather(1, top_plain)).abs().max()
    if not float(gap) < 1e-5:
        raise AssertionError(f"top-k differs from plain by score gap {gap}")
    log(f"[4 serve] full_sort_topk {TOPK_USERS} users k={TOPK_K}: "
        f"{float((top == top_plain).float().mean()):.4f} of slots equal, "
        f"max score gap of swaps {float(gap):.3e}")

    t0 = time.perf_counter()
    trainer.evaluate(dd.eval_test, is_test=True)
    eval_test_s = time.perf_counter() - t0
    log(f"[4 serve] evaluate(test) warm wall time {eval_test_s:.4f} s")
    profile_breakdown(torch, lambda: trainer.evaluate(dd.eval_test,
                                                      is_test=True),
                      "4 serve", "evaluate(test)")
    return dict(graphs=graphs, launches=launches, eval_test_s=eval_test_s,
                cfg=cfg, data=data, model=model)


def profile_breakdown(torch, fn, tag, what, top=8):
    """Where one call of fn() spends device time: torch.profiler's device
    time by kernel (memcpy and memset included), and the device's busy share
    of the wall time. Returns (wall us, busy us), or None when the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in ops)
    if not ops:
        log(f"[{tag}] profile: the profiler saw no device time "
            "(device busy share not measured)")
        return None
    log(f"[{tag}] profile of {what}: wall {wall_us:.0f} us, device "
        f"busy {busy_us:.0f} us ({busy_us / wall_us:.3f} of wall)")
    for t, count, key in ops[:top]:
        log(f"[{tag}] profile:   {t:10.1f} us  {t / busy_us:.3f}  "
            f"x{count:<5d} {key[:80]}")
    return wall_us, busy_us


def bound_of(n, nnz, d):
    """(bytes, least ms) of y = A @ x: cols, vals and row_ptr read once, x
    read once, y written once, against 2*nnz*d f32 operations."""
    n_bytes = nnz * 8 + (n + 1) * 4 + 2 * n * d * 4
    return n_bytes, max(n_bytes / HBM_BYTES_PER_S,
                        2 * nnz * d / F32_FLOPS_PER_S) * 1e3


def timed_graphs(served, power_law):
    """The graphs of the timed phases: the main path's two, then the
    power-law ones (main_path False: out of the kernels' totals)."""
    return {**{k: dict(g, main_path=True) for k, g in served["graphs"].items()},
            **power_law}


def phase_times(torch, spmm, graphs):
    """The forward launch by CUDA events, under the clean flush and (kernel
    and library) the dirty one, beside plain `segment` and torch.sparse.mm;
    the kernel's bf16 mode."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    per_graph = {}
    for name, g in graphs.items():
        prop, segment, x = g["prop"], g["segment"], g["x"]
        adj = prop.adj
        n, nnz, d = adj.n_nodes, adj.nnz, x.shape[1]
        lib_a = torch.sparse_csr_tensor(prop.row_ptr, prop.cols, prop.vals,
                                        size=(n, n), check_invariants=True)
        prop_bf16 = spmm.Propagator(adj, impl="kernel",
                                    compute_dtype="bfloat16", device="cuda")
        with torch.no_grad():
            k_ms = cuda_time_ms(lambda: prop(x), flush)
            k_dirty = cuda_time_ms(lambda: prop(x), flush, dirty=True)
            b_ms = cuda_time_ms(lambda: prop_bf16(x), flush)
            p_ms = cuda_time_ms(lambda: segment(x), flush)
            l_ms = cuda_time_ms(lambda: torch.sparse.mm(lib_a, x), flush)
            l_dirty = cuda_time_ms(lambda: torch.sparse.mm(lib_a, x), flush,
                                   dirty=True)
            k_warm, k_host = warm_time_ms(lambda: prop(x))
            l_warm, l_host = warm_time_ms(lambda: torch.sparse.mm(lib_a, x))
        n_bytes, bound_ms = bound_of(n, nnz, d)
        per_graph[name] = dict(
            n=n, nnz=nnz, d=d, max_degree=adj.max_degree,
            main_path=g["main_path"], items=prop.plan.n_items,
            cut_rows=prop.plan.n_fix,
            launches_per_eval_cache=g.get("hops", 0), ms=k_ms,
            plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms, bytes=n_bytes,
            bf16_ms=b_ms, ms_dirty_flush=k_dirty, ms_warm=k_warm,
            host_ms_per_call=k_host, library_ms_dirty_flush=l_dirty,
            library_ms_warm=l_warm, library_host_ms_per_call=l_host,
            max_abs_err=g["err"])
        log(f"[5 times] {name}: n={n} nnz={nnz} d={d} max_deg="
            f"{adj.max_degree} kernel {k_ms * 1e3:.2f} us (dirty flush "
            f"{k_dirty * 1e3:.2f}, warm {k_warm * 1e3:.2f}, bf16 mode "
            f"{b_ms * 1e3:.2f}; host {k_host * 1e3:.1f} us a call), plain "
            f"{p_ms * 1e3:.2f} us, torch.sparse.mm {l_ms * 1e3:.2f} us (dirty "
            f"flush {l_dirty * 1e3:.2f}, warm {l_warm * 1e3:.2f}; host "
            f"{l_host * 1e3:.1f} us a call), bound {bound_ms * 1e3:.2f} us "
            f"({n_bytes / 1e6:.2f} MB), {bound_ms / k_ms:.3f} of bound, "
            f"{g.get('hops', 0)} launches per eval_cache")
    return per_graph


# plans timed beside the chosen one: (ITEM_EDGES, ITEM_ROWS,
# ITEMS_PER_BLOCK, UNROLL)
SWEEP = [(e, 32, b, u) for e in (32, 48, 64, 80, 128) for b in (8, 16)
         for u in (4, 8)] + [(64, 16, 8, 8), (64, 64, 8, 8)]


def phase_sweep(torch, kernels, spmm, graphs):
    """The forward kernel at other plan geometries (SWEEP), on every timed
    graph, clean flush; each result checked against the chosen plan's."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for name, g in graphs.items():
        prop, x = g["prop"], g["x"]
        with torch.no_grad():
            y_ref = prop(x)
        times = []
        for geometry in SWEEP:
            plan = spmm.plan_csr(prop.adj.row_ptr, *geometry)
            csr = prop.csr()[:3] + (
                plan.with_table(torch.from_numpy(plan.table).cuda()),)
            check_close(f"{name} plan {geometry}", kernels.spmm_csr(*csr, x),
                        y_ref)
            ms = cuda_time_ms(lambda: kernels.spmm_csr(*csr, x), flush,
                              reps=20)
            times.append("/".join(map(str, geometry)) + f" {ms * 1e3:.2f}")
        log(f"[5 sweep] {name} (item_edges/item_rows/items_per_block/unroll "
            "us): " + ", ".join(times))


def random_adjacency(rng, n, kind, **kw):
    """A NormalizedAdjacency over n nodes that is not symmetric: random_csr's
    random values, or D^-1 A over its edges (`row-normalized`)."""
    from foodrec_tpu_torch.ops.graph import NormalizedAdjacency

    row_ptr, cols, vals = random_csr(rng, n, n, **kw)
    deg = np.diff(row_ptr)
    if kind == "row-normalized":
        vals = np.repeat(1.0 / np.maximum(deg, 1), deg).astype(np.float32)
    return NormalizedAdjacency(
        n_nodes=n, rows=np.repeat(np.arange(n, dtype=np.int32), deg),
        cols=cols, vals=vals, row_ptr=row_ptr, ell_cols=None, ell_vals=None,
        max_degree=int(deg.max()) if n else 0, symmetric=False)


def spmm_grad_check(torch, spmm, name, adj, d, rng, kernel=None,
                    segment=None, tag="6 train"):
    """d/dx of sum(g * A @ x) through SpmmCSR (the kernel on A^T) against
    `segment` autograd; in bf16 mode against `spmm_csr_plain` on A^T and g
    rounded to bf16; two kernel runs of each bitwise equal."""
    dev = torch.device("cuda")
    kernel = kernel or spmm.Propagator(adj, impl="kernel", device=dev)
    segment = segment or spmm.Propagator(adj, impl="segment", device=dev)
    kernel_bf16 = spmm.Propagator(adj, impl="kernel", compute_dtype="bfloat16",
                                  device=dev)
    x, g = (torch.from_numpy(rng.standard_normal((adj.n_nodes, d)).astype(
        np.float32)).to(dev) for _ in range(2))

    def grad(prop):
        xx = x.clone().requires_grad_(True)
        return torch.autograd.grad(prop(xx), xx, g)[0]

    errs = []
    for mode, prop, g_ref in (
            ("f32", kernel, grad(segment)),
            ("bf16", kernel_bf16,
             spmm.spmm_csr_plain(*kernel.csr(transpose=True)[:3],
                                 bf16_round(g)))):
        g1, g2 = grad(prop), grad(prop)
        torch.cuda.synchronize()
        errs.append(check_close(f"{name} grad {mode}", g1, g_ref))
        if not torch.equal(g1, g2):
            raise AssertionError(f"{name} {mode}: two kernel backward runs "
                                 "differ")
    log(f"[{tag}] grad {name}: n={adj.n_nodes} nnz={adj.nnz} d={d} "
        f"symmetric={adj.symmetric} kernel vs plain max|d| f32 "
        f"{errs[0]:.3e} bf16 {errs[1]:.3e} bar={bar(g_ref):.3e} "
        f"bitwise-repeat=ok")
    return max(errs)


def draw_batches(torch, dd, n_batches, bs, seed):
    """n_batches (u, pos, neg) batches of one device permutation of the train
    pairs, negatives from the on-device sampler."""
    from foodrec_tpu_torch.data.sampling import sample_negatives

    gen = torch.Generator(device="cuda").manual_seed(seed)
    train_u = torch.as_tensor(dd.train_u).cuda().long()
    train_i = torch.as_tensor(dd.train_i).cuda().long()
    excl = torch.from_numpy(dd.excl_bitmap.view(np.int32)).cuda()
    perm = torch.randperm(len(train_u), generator=gen, device="cuda")
    out = []
    for b in range(n_batches):
        idx = perm[b * bs:(b + 1) * bs]
        u = train_u[idx]
        out.append((u, train_i[idx],
                    sample_negatives(u, excl, dd.num_items, gen)))
    return out


def loss_and_grads(torch, model, batch):
    model.zero_grad(set_to_none=True)
    parts = model.calculate_loss(*batch)
    sum(parts).backward()
    return (torch.stack(parts).detach(),
            {k: p.grad for k, p in model.named_parameters()})


def phase_train_paths(torch, served):
    """calculate_loss gradients through the kernel against `segment` at the
    same parameters, along a 20-step Adam trajectory of the kernel path; and
    the loss parts of 20 Adam steps through each path on the same batches.
    Dropout 0."""
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg, data = served["cfg"], served["data"]

    def fresh(impl):
        m = get_model("CIKM_Model")(
            cfg, data, generator=torch.Generator().manual_seed(SEED))
        if impl == "segment":
            swap_propagators(m, "segment")
        m.attn_dropout = 0.0
        return m

    mk, ms, mp = fresh("kernel"), fresh("segment"), fresh("segment")
    tk, ts = Trainer(cfg, mk), Trainer(cfg, ms)
    batches = draw_batches(torch, data.device_data, COMPARE_STEPS,
                           cfg["train_batch_size"], SEED + 1)
    grad_err, traj = 0.0, np.zeros((COMPARE_STEPS, 4))
    for step, batch in enumerate(batches):
        mp.load_state_dict(mk.state_dict())
        parts_k, grads_k = loss_and_grads(torch, mk, batch)
        parts_p, grads_p = loss_and_grads(torch, mp, batch)
        for name, gk in grads_k.items():
            grad_err = max(grad_err, check_close(
                f"step {step} grad {name}", gk, grads_p[name]))
        check_close(f"step {step} loss parts", parts_k, parts_p)
        tk.optimizer.step()
        parts_s = ts.train_steps([batch])
        traj[step] = ((parts_k - parts_s).abs() / parts_s.abs()).cpu().numpy()
        if step == 0:
            log(f"[6 train] calculate_loss kernel vs segment, same params: "
                f"{len(grads_k)} gradient leaves within the bar, loss parts "
                f"{parts_k.tolist()}")
    worst = traj.max(axis=0)
    log(f"[6 train] {COMPARE_STEPS} steps, gradients kernel vs segment at the "
        f"kernel path's parameters: all leaves within the bar, max|d| "
        f"{grad_err:.3e}")
    log(f"[6 train] {COMPARE_STEPS} Adam steps through each path: worst "
        f"relative loss-part difference (mf, health, kd, reg) "
        f"{[float(f'{w:.3e}') for w in worst]}, by step "
        f"{[float(f'{r:.2e}') for r in traj.max(axis=1)]}")
    if not (worst <= TRAJECTORY_TOL).all():
        raise AssertionError(f"trajectories differ by {worst}, bars "
                             f"{TRAJECTORY_TOL}")
    return grad_err


def phase_train(torch, kernels, spmm, served):
    from foodrec_tpu_torch.engine.trainer import Trainer

    rng = np.random.default_rng(SEED + 6)
    dev = torch.device("cuda")
    errs = []
    # random graphs: hub + empty rows, odd n, nnz = 0 (not symmetric), a
    # row-normalized one, and a symmetric normalized one (A^T = A's tables)
    for name, n, d, kind, kw in (
            ("hub+empty d64", 10_001, 64, "random", dict(hub_degree=6000)),
            ("odd n d96", 4_097, 96, "random", dict(hub_degree=700)),
            ("nnz=0 d64", 1_000, 64, "random", dict(avg_degree=0)),
            ("row-normalized d64", 8_191, 64, "row-normalized",
             dict(hub_degree=3000))):
        errs.append(spmm_grad_check(torch, spmm, name,
                                    random_adjacency(rng, n, kind, **kw),
                                    d, rng))
    from foodrec_tpu_torch.ops.graph import sym_normalized_adjacency

    n = 12_289
    rows = np.concatenate([rng.integers(0, n, 60_000), np.zeros(5000, int)])
    cols = np.concatenate([rng.integers(0, n, 60_000),
                           rng.choice(np.arange(1, n), 5000, replace=False)])
    errs.append(spmm_grad_check(torch, spmm, "symmetric hub d64",
                                sym_normalized_adjacency(rows, cols, n), 64,
                                rng))
    for name, g in served["graphs"].items():
        errs.append(spmm_grad_check(torch, spmm, name, g["prop"].adj, 64, rng,
                                    kernel=g["prop"], segment=g["segment"]))

    model_grad_err = phase_train_paths(torch, served)
    torch.cuda.empty_cache()

    # the main path: one epoch at Foodcom scale, full config, counted
    cfg, data, model = served["cfg"], served["data"], served["model"]
    dd = data.device_data
    trainer = Trainer(cfg, model)
    step_parts = []
    calculate_loss = model.calculate_loss

    def recording_loss(*args, **kwargs):
        parts = calculate_loss(*args, **kwargs)
        step_parts.append(torch.stack(parts).detach())
        return parts

    model.calculate_loss = recording_loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    t0 = time.perf_counter()
    parts = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    model.calculate_loss = calculate_loss
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = len(step_parts)
    log(f"[6 train] epoch: n_train={trainer.n_train} batch="
        f"{trainer.train_batch_size} steps={n_steps} (tail "
        f"{trainer.n_train - (trainer.n_batches - 1) * trainer.train_batch_size}"
        f") dropout={model.attn_dropout} lr={trainer.scheduler.get_last_lr()[0]}"
        f" wall {epoch_s:.3f} s, {n_steps / epoch_s:.1f} steps/s, peak device "
        f"memory {peak_gb:.2f} GiB")
    if n_steps != trainer.n_batches:
        raise AssertionError(f"{n_steps} steps, expected {trainer.n_batches}")
    per_step = {k: v / n_steps for k, v in launches.items()}
    log(f"[6 train] launches over the epoch: {launches} ({per_step} a step)")
    hops = model.n_layers + model.ui_layers
    if launches != {"spmm_csr": hops * n_steps, "spmm_csr_bwd": hops * n_steps}:
        raise AssertionError(f"expected {hops} forward and {hops} backward "
                             f"launches a step, got {launches}")
    steps = torch.stack(step_parts).cpu().numpy()
    if not np.isfinite(steps).all():
        raise AssertionError("a loss part is not finite")
    first, last = (steps[:LOSS_WINDOW].sum(), steps[-LOSS_WINDOW:].sum())
    log(f"[6 train] loss parts (mf, health, kd, reg) per step, epoch mean "
        f"{(parts.cpu().numpy() / n_steps).tolist()}; first {LOSS_WINDOW} "
        f"steps sum {first:.4f}, last {LOSS_WINDOW} steps sum {last:.4f}")
    if not last < first:
        raise AssertionError("the loss did not fall over the epoch")
    trainer.scheduler.step()

    t0 = time.perf_counter()
    metrics = trainer.evaluate(dd.eval_valid)
    vals = np.array(list(metrics.values()))
    if not (np.isfinite(vals).all() and (vals >= 0).all()
            and (vals <= 1).all()):
        raise AssertionError(f"valid metrics out of range: {metrics}")
    log(f"[6 train] evaluate(valid) after one epoch: {json.dumps(metrics)} "
        f"{time.perf_counter() - t0:.3f} s")

    batches = draw_batches(torch, dd, PROFILE_STEPS, trainer.train_batch_size,
                           SEED + 2)
    prof = profile_breakdown(torch, lambda: trainer.train_steps(batches),
                             "6 train", f"{PROFILE_STEPS} train steps")
    return dict(launches=launches, epoch_s=epoch_s, n_steps=n_steps,
                peak_gb=peak_gb, grad_err=max(errs),
                model_grad_err=model_grad_err,
                busy_share=None if prof is None else prof[1] / prof[0],
                metrics=metrics)


def phase_backward_times(torch, spmm, graphs):
    """The backward launch (the kernel on A^T) by CUDA events, under the
    clean flush and (kernel) the dirty one, beside the plain `segment`
    backward and torch.sparse.mm on A^T."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    hops_per_step = {"ui_prop": 1, "ri_prop": 2}
    per_graph = {}
    for name, g in graphs.items():
        prop, segment, x = g["prop"], g["segment"], g["x"]
        adj = prop.adj
        n, nnz, d = adj.n_nodes, adj.nnz, x.shape[1]
        a_t = prop.csr(transpose=True)
        g_out = torch.randn_like(x)
        xr = x.clone().requires_grad_(True)
        y_seg = segment(xr)
        lib_at = torch.sparse_csr_tensor(*a_t[:3], size=(n, n),
                                         check_invariants=True)

        def kernel(bf16=False):
            return spmm.spmm_csr(*a_t, g_out, count="spmm_csr_bwd",
                                 round_bf16=bf16)

        k_ms = cuda_time_ms(kernel, flush)
        k_dirty = cuda_time_ms(kernel, flush, dirty=True)
        b_ms = cuda_time_ms(lambda: kernel(bf16=True), flush)
        p_ms = cuda_time_ms(lambda: torch.autograd.grad(
            y_seg, xr, g_out, retain_graph=True), flush)
        l_ms = cuda_time_ms(lambda: torch.sparse.mm(lib_at, g_out), flush)
        n_bytes, bound_ms = bound_of(n, nnz, d)
        per_graph[name] = dict(
            n=n, nnz=nnz, d=d, max_degree=adj.max_degree,
            main_path=g["main_path"],
            launches_per_train_step=hops_per_step.get(name, 0),
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
            bytes=n_bytes, bf16_ms=b_ms, ms_dirty_flush=k_dirty,
            symmetric=adj.symmetric)
        log(f"[6 times] backward {name}: n={n} nnz={nnz} d={d} kernel on A^T "
            f"{k_ms * 1e3:.2f} us (dirty flush {k_dirty * 1e3:.2f}, bf16 mode "
            f"{b_ms * 1e3:.2f}), plain "
            f"segment backward {p_ms * 1e3:.2f} us, torch.sparse.mm(A^T) "
            f"{l_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({n_bytes / 1e6:.2f} MB), {bound_ms / k_ms:.3f} of bound, "
            f"{hops_per_step.get(name, 0)} launches per train step")
    return per_graph


def kernel_entry(per_graph, per_key, **fields):
    """A kernels-JSON entry: times summed over the launches of one `per` on
    the main path's graphs; the power-law graphs (main_path False) stand
    in per_graph only."""
    main = [g for g in per_graph.values() if g["main_path"]]

    def total(key):
        return sum(g[key] * g[per_key] for g in main)

    ops = sum(2 * g["nnz"] * g["d"] * g[per_key] for g in main)
    entry = {
        "route": "cuda", "source": "foodrec_tpu_torch/csrc/spmm_csr.cu",
        **fields,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("bytes" if total("bytes") / HBM_BYTES_PER_S
                     >= ops / F32_FLOPS_PER_S else "operations"),
        "library_ms": total("library_ms"),
        "per_graph": per_graph,
    }
    return entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and check the kernels)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from foodrec_tpu_torch.ops import _kernels, spmm

    phase_device(torch)
    phase_build(_kernels)
    phase_random_graphs(torch, _kernels, spmm)
    power_law = phase_power_law(torch, _kernels, spmm)
    if args.kernels_only:
        return 0
    served = phase_serving(torch, _kernels, spmm)
    graphs = timed_graphs(served, power_law)
    floor = phase_floor(torch)
    per_graph = phase_times(torch, spmm, graphs)
    phase_sweep(torch, _kernels, spmm, graphs)
    trained = phase_train(torch, _kernels, spmm, served)
    bwd_graph = phase_backward_times(torch, spmm, graphs)

    record = {"kernels": [
        kernel_entry(
            per_graph, "launches_per_eval_cache", name="spmm_csr",
            replaces="foodrec_tpu/ops/spmm.py:129",
            launches=served["launches"] + trained["launches"]["spmm_csr"],
            launches_by_path={"serve": served["launches"],
                              "train_epoch": trained["launches"]["spmm_csr"]},
            max_abs_err=max(g["max_abs_err"] for g in per_graph.values()),
            per="one eval_cache: 2 ri_prop hops + 1 ui_prop hop",
            evaluate_test_s=served["eval_test_s"], timing_floor=floor),
        kernel_entry(
            bwd_graph, "launches_per_train_step", name="spmm_csr_bwd",
            replaces="foodrec_tpu/ops/spmm.py:129 (custom VJP :263-273)",
            launches=trained["launches"]["spmm_csr_bwd"],
            max_abs_err=max(trained["grad_err"], *(
                g["grad_err"] for g in power_law.values())),
            per="one train step: 2 ri_prop + 1 ui_prop backward hops",
            epoch_s=trained["epoch_s"], epoch_steps=trained["n_steps"],
            steps_per_s=trained["n_steps"] / trained["epoch_s"],
            busy_share_20_steps=trained["busy_share"],
            peak_memory_gib=trained["peak_gb"],
            calculate_loss_grad_max_abs_err=trained["model_grad_err"]),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
