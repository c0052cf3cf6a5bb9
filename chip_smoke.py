#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`foodrec_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels

Drives the port's serving path for CIKM_Model at full width (embedding 64,
2 recipe-ingredient hops + 1 user-item hop) on the Foodcom-scale synthetic
catalog (7,596 users x 29,943 items x 4,963 ingredients), with random
weights from seed 999:

  1. device: card name and power limit, compute capability 9.0, TF32 off
  2. build: every CUDA kernel from the sources in the checkout
  3. each kernel against its plain PyTorch version on random graphs (hub
     row, empty rows, odd n, nnz = 0; d in {64, 16}), and run to run bitwise
  4. serving: dataset -> Config/FoodData/DeviceData -> CIKM_Model on cuda;
     kernel against plain on both real adjacencies; eval_cache through the
     kernel and through `segment`; Trainer.evaluate on valid and test;
     full_sort_topk for 64 users against the plain path; launch counts
  5. times: CUDA events, L2 flushed before each launch, medians

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
TOPK_USERS, TOPK_K = 64, 50


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


def cuda_time_ms(fn, flush, reps=50, warmup=5):
    """Median device time of fn() in ms: CUDA events around each call, with
    the L2 cache flushed (a 256 MB write) before each."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def random_csr(rng, n, n_cols, avg_degree=8, empty_frac=0.2, hub_degree=0):
    deg = rng.poisson(avg_degree, n)
    deg[rng.random(n) < empty_frac] = 0
    if hub_degree:
        deg[n // 2] = hub_degree
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = rng.integers(0, n_cols, row_ptr[-1]).astype(np.int32)
    vals = rng.standard_normal(row_ptr[-1]).astype(np.float32)
    return row_ptr, cols, vals


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


def phase_random_graphs(torch, kernels, spmm):
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    cases = [
        ("hub+empty d64", 10_001, 64, dict(hub_degree=6000)),
        ("hub+empty d16", 10_001, 16, dict(hub_degree=6000)),
        ("odd n d96", 4_097, 96, dict(hub_degree=700)),
        ("nnz=0 d64", 1_000, 64, dict(avg_degree=0)),
    ]
    for name, n, d, kw in cases:
        row_ptr, cols, vals = (torch.from_numpy(a).to(dev)
                               for a in random_csr(rng, n, n, **kw))
        x = torch.from_numpy(
            rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        y1 = kernels.spmm_csr(row_ptr, cols, vals, x)
        y2 = kernels.spmm_csr(row_ptr, cols, vals, x)
        y_plain = spmm.spmm_csr_plain(row_ptr, cols, vals, x)
        torch.cuda.synchronize()
        err = check_close(name, y1, y_plain)
        if not torch.equal(y1, y2):
            raise AssertionError(f"{name}: two kernel runs differ")
        deg = (row_ptr[1:] - row_ptr[:-1])
        log(f"[3 random] {name}: n={n} nnz={cols.numel()} "
            f"max_deg={int(deg.max())} empty_rows={int((deg == 0).sum())} "
            f"max|d|={err:.3e} bar={bar(y_plain):.3e} bitwise-repeat=ok")


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
    dd = DeviceData.from_food_data(data)
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
        graphs[name] = dict(prop=prop, segment=segment, x=x, err=err,
                            hops=hops)
        log(f"[4 serve] {name}: n={adj.n_nodes} nnz={adj.nnz} "
            f"max_deg={adj.max_degree} kernel vs plain max|d|={err:.3e} "
            f"bar={bar(y_plain):.3e} bitwise-repeat=ok")

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
                                                      is_test=True))
    return dict(graphs=graphs, launches=launches, eval_test_s=eval_test_s)


def profile_breakdown(torch, fn, top=8):
    """Where one call of fn() spends device time: torch.profiler's device
    time by kernel (memcpy and memset included), and the device's busy share
    of the wall time."""
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
        log("[4 serve] profile: the profiler saw no device time "
            "(device busy share not measured)")
        return
    log(f"[4 serve] profile of evaluate(test): wall {wall_us:.0f} us, device "
        f"busy {busy_us:.0f} us ({busy_us / wall_us:.3f} of wall)")
    for t, count, key in ops[:top]:
        log(f"[4 serve] profile:   {t:10.1f} us  {t / busy_us:.3f}  "
            f"x{count:<5d} {key[:80]}")


def phase_times(torch, served):
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    per_graph = {}
    for name, g in served["graphs"].items():
        prop, segment, x = g["prop"], g["segment"], g["x"]
        adj = prop.adj
        n, nnz, d = adj.n_nodes, adj.nnz, x.shape[1]
        lib_a = torch.sparse_csr_tensor(prop.row_ptr, prop.cols, prop.vals,
                                        size=(n, n), check_invariants=True)
        with torch.no_grad():
            k_ms = cuda_time_ms(lambda: prop(x), flush)
            p_ms = cuda_time_ms(lambda: segment(x), flush)
            l_ms = cuda_time_ms(lambda: torch.sparse.mm(lib_a, x), flush)
        n_bytes = nnz * 8 + (n + 1) * 4 + 2 * n * d * 4
        flops = 2 * nnz * d
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        per_graph[name] = dict(
            n=n, nnz=nnz, d=d, launches_per_eval_cache=g["hops"], ms=k_ms,
            plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms, bytes=n_bytes,
            max_abs_err=g["err"])
        log(f"[5 times] {name}: n={n} nnz={nnz} d={d} kernel {k_ms * 1e3:.2f} us, "
            f"plain {p_ms * 1e3:.2f} us, torch.sparse.mm {l_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({n_bytes / 1e6:.2f} MB), "
            f"{g['hops']} launches per eval_cache")
    return per_graph


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
    if args.kernels_only:
        return 0
    served = phase_serving(torch, _kernels, spmm)
    per_graph = phase_times(torch, served)

    def per_eval_cache(key):
        return sum(g[key] * g["launches_per_eval_cache"]
                   for g in per_graph.values())

    ops = sum(2 * g["nnz"] * g["d"] * g["launches_per_eval_cache"]
              for g in per_graph.values())
    nbytes = per_eval_cache("bytes")
    record = {"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "foodrec_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "foodrec_tpu/ops/spmm.py:129",
        "launches": served["launches"],
        "max_abs_err": max(g["max_abs_err"] for g in per_graph.values()),
        "ms": per_eval_cache("ms"),
        "plain_ms": per_eval_cache("plain_ms"),
        "bound_ms": per_eval_cache("bound_ms"),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops / F32_FLOPS_PER_S else "operations"),
        "library_ms": per_eval_cache("library_ms"),
        "per": "one eval_cache: 2 ri_prop hops + 1 ui_prop hop",
        "per_graph": per_graph,
        "evaluate_test_s": served["eval_test_s"],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
