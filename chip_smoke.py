#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`foodrec_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels
    python3 chip_smoke.py --mesh-only     # phases 1, 2 and 10
    python3 chip_smoke.py --pipeline-only # phases 1, 2 and 11

Drives the port's serving and training paths for CIKM_Model at full width
(embedding 64, 2 recipe-ingredient hops + 1 user-item hop, a 2-layer post-LN
encoder with 2 heads, both target attentions, the health MLP, trainable
2048-d image and 512-d text tables; batch 512, dropout 0.5, Adam lr 0.002),
then those of LightGCN, BM3, FGCN, PRICAI_ModelX (CLUSSL) and SCHGN with
their shipped configs, on the Foodcom-scale synthetic catalog (7,596 users x
29,943 items x 4,963 ingredients x 60 calorie levels, 2,000 k-means
clusters), with random weights from seed 999:

  1. device: card name and power limit, compute capability 9.0, TF32 off
  2. build: every CUDA kernel from the sources in the checkout
  3. each kernel against its plain PyTorch version, in f32 and in bf16 mode,
     on random graphs (hub row, empty rows, odd n, nnz = 0; d in {16, 64,
     96}), on two power-law graphs (Zipf item popularity at Foodcom's and
     Allrecipes' user-item sizes) and on a CLUSSL item-cluster graph at the
     upstream degree (6 clusters an item, ~90 items a cluster row), forward
     and backward, run to run bitwise; the by-user metrics kernel against
     its plain version, bit for bit, at the evaluation's block (256 users
     x 640 slots), on the last padded block and on edge cases, then timed
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
  7. zoo: for each of LightGCN, BM3, FGCN (three row-normalized graphs, so
     its backward runs on A^T's own tables), PRICAI_ModelX and SCHGN (one
     GCNConv hop over a directed graph, whose A^T has the calorie levels'
     long rows, so every train step runs the fix-up kernel): the graphs
     `auto` routed, the kernel against plain on each (forward, gradient),
     eval_cache and one calculate_loss gradient through the kernel and
     through `segment`, 20 Adam steps through each path, one full epoch
     with its launches counted, evaluate on valid and test, full_sort_topk
     against the plain path, chunk by chunk (SCHGN: also full_sort_predict
     on that block of users, against score_items over the block and all
     items, bitwise, else within the bar); the kernel's times on FGCN's,
     CLUSSL's and SCHGN's graphs; and the LightGCN accuracy gate of the JAX
     package's bench (AUC >= 0.80, NDCG@20 >= 0.38 after 30 epochs on the
     structured toy synthetic) through the kernel
  8. the experiment driver, in build/driver/ (log/, ckp/, recommend_topk/):
     the CLI (`runner.main`, CIKM_Model's shipped grid, 2 epochs) with its
     launches counted against the hops, its best checkpoint reloaded into a
     fresh model (equal test metrics); one Mirror Gradient epoch (beta 3,
     launches counted); the full-sort eval of every user over the catalog
     (k = 50, with the top-k CSV) and the sampled eval (each test positive
     among its user's 500 negatives), each against the `segment` path; the
     cold, sense and health-level studies; a 2-epoch fit stopped after
     epoch 0 (save_state_every: 1) and resumed, against the run that was
     not stopped
  9. the training and data options, through the kernel: CIKM_Model with
     the scalar health level, health-stratified negatives and the padded
     final batch for one epoch (the negatives' invariants asserted); 20
     steps of sgd, adagrad and rmsprop
     through the kernel against `segment`; one epoch each of CIKM_Model and
     BM3 with frozen modality tables; LightGCN's fit with
     profile_trace_dir, whose trace must name the kernel
 10. scale-out (`mesh_shape` through torch.distributed), in spawned rank
     groups on the one card, each with a deadline: (a) one NCCL rank
     started as torchrun starts it, `runner.main` for one CIKM_Model
     epoch (launches asserted), its checkpoint reloaded into one process,
     20 SGD steps against one process (bitwise); (b) {data: 2} and (c)
     {model: 2} over gloo, two ranks sharing the card: CIKM_Model, BM3,
     SCHGN and CLUSSL (its prototype tables row-sharded), 20 SGD steps
     each, every step's reduced gradient against one process's at the same
     parameters, the trajectory against one process's and against a run
     one rounding away; CIKM_Model's full-sort test through
     distributed_full_sort_topk, equal ids and metrics; which collectives
     gloo runs on CUDA tensors; (d) dryrun_multichip(4) over gloo. Each
     rank's launches are summed into the record
 11. the offline data pipeline, in build/pipeline/: (a) a raw Food.com tree
     at the Kaggle release's size (1,132,367 interactions, 231,637 recipes,
     178,265 with ingredient ids, ~8k ingredient names), generated from a
     seed; (b) the port's preprocess CLI on it, the k-means (2,000 clusters
     of the 2048-d image and the 512-d text features) on the card, each
     stage timed; every contract file, FoodData on the output, each
     k-means' inertia below its k-means++ init's, the first cluster edge of
     1,000 items the nearest centre in float64; (c) the text extractor with
     an encoder of T5-small's width over every ingredient name and title,
     and the image extractor with a conv backbone over generated JPEGs,
     each against the same call on the CPU; (d) CIKM_Model's CLI for one
     epoch and 20 Adam steps of CLUSSL on the 2,000 clusters and centres
     the card wrote, through the kernel, launches counted, the kernel held
     against plain (forward f32 and bf16, gradient, bitwise repeat) on each
     of their graphs first. Its stage times are a JSON line of their own
 12. the flagship step (run right after phase 3): `entry()` of
     foodrec_tpu_torch.entry, CIKM_Model's summed loss on the toy
     synthetic of the JAX package's `__graft_entry__.entry`, forward and
     backward through the kernel (3 + 3 launches), the loss and every
     gradient against the same step through `segment`, the step's time

Any failed check raises and the script exits non-zero. The line before the
last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. The kernel build lands in build/kernels/ and
the datasets in build/smoke_data/ and build/pipeline/, all gitignored.
"""

import argparse
import copy
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
# a CLUSSL item-cluster graph at the upstream degree: (items, clusters,
# clusters an item); the synthetic catalog draws 2 an item
# (foodrec_tpu_torch/data/synthetic.py), upstream k-means data has 6
CLUSTER_GRAPH = (29943, 2000, 6)
TOPK_USERS, TOPK_K = 64, 50
TOPK_CHUNK = 8192     # full_sort_topk's item chunk
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
# phase 7: the five models with their shipped configs; CLUSSL's n_cluster
# (2000 in its yaml) is the synthetic catalog's
ZOO = ("LightGCN", "BM3", "FGCN", "PRICAI_ModelX", "SCHGN")
ZOO_OVERRIDES = {"PRICAI_ModelX": {"n_cluster": FOODCOM_SCALE["n_clusters"]}}
# the loss parts of 20 Adam steps through the kernel and through `segment`,
# relative, per model (zoo_paths). Measured on an H100 80GB HBM3 at 700 W:
# LightGCN, BM3 and CLUSSL within 2e-7 at every step; FGCN's mf within
# 2.4e-6 and its reg (~2e-6 in value, from the normalized user outputs and
# the raw item table) parting to 4.0e-4 by step 19, as two float32 Adam
# runs part where gradients sit near Adam's eps (see TRAJECTORY_TOL);
# SCHGN, its score dropout, SSL masks and encoder dropout drawn alike on
# both paths, within 8.7e-8 (bpr), 8.1e-8 (reg) and 0 (ssl).
ZOO_TRAJECTORY_TOL = {
    "LightGCN": np.array([1e-5, 1e-5]),            # mf, reg
    "BM3": np.array([1e-5, 1e-5, 1e-5]),           # ui + iu, reg, cl
    "FGCN": np.array([1e-4, 1e-2]),                # mf, reg
    "PRICAI_ModelX": np.array([1e-5, 1e-5, 1e-5]),  # mf, cl, reg
    "SCHGN": np.array([1e-5, 1e-5, 1e-5]),          # bpr, reg, ssl
}
# the zoo's graphs with a pattern of their own, timed by phases 5 and 6's
# functions; the others are ui_prop's and ri_prop's adjacencies again
TIMED_ZOO_GRAPHS = ("FGCN.ru_prop", "FGCN.ir_prop", "FGCN.ii_prop",
                    "PRICAI_ModelX.image_prop", "PRICAI_ModelX.text_prop",
                    "SCHGN.gcn_prop")
# the LightGCN accuracy gate of the JAX package's bench (bench.py:114-131):
# parity_check.py's structured toy synthetic (TOY_SCALE, parity_check.py:
# 32-35), 100 negatives, seed 999, 30 epochs
GATE_DATASET = "StructSynth"
GATE_SCALE = dict(n_users=800, n_items=1600, n_ingredients=300,
                  n_cal_levels=20, n_health_levels=6, n_clusters=50,
                  img_dim=64, txt_dim=32, neg_num=100, latent_dim=8,
                  train_per_user=(10, 21), valid_per_user=(2, 4),
                  test_per_user=(2, 5), seed=17)
GATE_EPOCHS = 30
GATE_AUC, GATE_NDCG20 = 0.80, 0.38
# phase 8: the experiment driver's outputs (log/, ckp/, recommend_topk/) go
# under DRIVER_ROOT, the working directory while it runs
DRIVER_ROOT = os.path.join(ROOT, "build", "driver")
DRIVER_EPOCHS = 2
MG_SETTINGS = {"alpha1": 1.0, "alpha2": 0.1, "beta": 3}
STUDY_FLAGS = {"cold_study": True, "sense_study": True,
               "health_level_study": True}


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


def cluster_adjacency(n_items, n_clusters, per_item, seed=0):
    """A CLUSSL item-cluster graph (pricai_modelx.py:63-78):
    `per_item` uniform cluster draws an item, items then clusters, the
    symmetric normalization of the model's item-side graphs."""
    from foodrec_tpu_torch.ops.graph import (
        bipartite_offset_edges,
        sym_normalized_adjacency,
    )

    rng = np.random.default_rng(seed)
    triples = np.stack([np.repeat(np.arange(n_items), per_item),
                        rng.integers(0, n_clusters, n_items * per_item)], 1)
    rows, cols = bipartite_offset_edges(triples, offset_tail=n_items)
    return sym_normalized_adjacency(rows, cols, n_items + n_clusters)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    cap = torch.cuda.get_device_capability()
    log(f"[1 device] {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"expected compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


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
    """The kernel on the two power-law graphs and on the CLUSSL cluster
    graph at the upstream degree, at d 64: forward against `spmm_csr_plain`
    and the gradient (SpmmCSR) against `segment` autograd, in f32 and bf16
    mode, two runs of each bitwise equal. Returns the graphs for the timed
    phases."""
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    graphs = {}
    shaped = {name: (lambda a=args: zipf_adjacency(*a))
              for name, args in POWER_LAW.items()}
    shaped["clussl_upstream_clusters"] = lambda: cluster_adjacency(
        *CLUSTER_GRAPH)
    for name, build in shaped.items():
        adj = build()
        prop = spmm.Propagator(adj, impl="kernel", device=dev)
        segment = spmm.Propagator(adj, impl="segment", device=dev)
        x = torch.from_numpy(rng.standard_normal(
            (adj.n_nodes, 64)).astype(np.float32)).to(dev)
        errs = kernel_vs_plain(torch, kernels, spmm, name, prop.csr(), x)
        deg = np.diff(adj.row_ptr)
        hub = deg > 256
        tag = "3 clusters" if name.startswith("clussl") else "3 power-law"
        log(f"[{tag}] {name}: n={adj.n_nodes} nnz={adj.nnz} "
            f"max_deg={int(deg.max())} p99_deg={np.percentile(deg, 99):.0f} "
            f"rows>256={int(hub.sum())} ({deg[hub].sum() / adj.nnz:.3f} of "
            f"nnz) empty_rows={int((deg == 0).sum())} items="
            f"{prop.plan.n_items} cut_rows={prop.plan.n_fix} kernel vs plain "
            f"max|d| f32 {errs[0]:.3e} bf16 {errs[1]:.3e} bitwise-repeat=ok")
        grad_err = spmm_grad_check(torch, spmm, name, adj, 64, rng,
                                   kernel=prop, segment=segment, tag=tag)
        graphs[name] = dict(prop=prop, segment=segment, x=x, err=max(errs),
                            grad_err=grad_err, main_path=False)
    return graphs


METRIC_BLOCK = (256, 640)  # the main path's by-user block: users x slots
METRIC_USERS = 7596        # Foodcom's test users: the last block is padded
METRIC_NEG = 500           # sampled negatives a user
BY_USER_CASES = ("pos_neg_ties", "signed_zeros", "nan_inf", "few_candidates",
                 "no_positives", "many_positives", "odd_width")


def by_user_case(name, seed=SEED):
    """One edge case of the by-user metrics, as numpy: (scores float32
    [B, C], n_pos int64 [B], n_cand int64 [B], neg_num). The card holds the
    kernel to the plain path on each, the CPU tests the plain path to the
    JAX package."""
    rng = np.random.default_rng([seed, BY_USER_CASES.index(name)])
    b, neg_num = 12, 40
    c = {"odd_width": 37, "many_positives": 96}.get(name, 64)
    n_pos = rng.integers(1, 9, b)
    if name == "no_positives":
        n_pos[:] = 0
    elif name == "many_positives":
        n_pos = rng.integers(21, 48, b)
    n_cand = np.minimum(n_pos + rng.integers(12, c, b), c)
    if name == "few_candidates":
        n_cand = np.minimum(n_pos + rng.integers(0, 12, b), 19)
    scores = rng.standard_normal((b, c)).astype(np.float32)
    if name == "pos_neg_ties":
        scores = np.round(scores * 2) / 2  # a coarse grid: many ties
        scores[0] = 0.25                   # every score tied: positives win
    elif name == "signed_zeros":
        scores[:, :] = np.where(rng.random((b, c)) < 0.5, scores, 0.0)
        neg_zero = np.copysign(np.float32(0), -1)
        for row in range(b):  # -0.0 positives over +0.0 negatives, and back
            pos_zero = row % 2 == 0
            scores[row, :n_pos[row]] = neg_zero if pos_zero else 0.0
            rest = scores[row, n_pos[row]:] == 0
            scores[row, n_pos[row]:][rest] = 0.0 if pos_zero else neg_zero
    elif name == "nan_inf":
        special = np.float32([np.nan, np.copysign(np.nan, -1), np.inf,
                              -np.inf])
        hit = rng.random((b, c)) < 0.3
        scores[hit] = rng.choice(special, int(hit.sum()))
    elif name == "no_positives":
        n_cand[: b // 3] = 0   # the pad rows of a last block
        scores[: b // 3] = scores[0, 0]
    return scores, n_pos.astype(np.int64), n_cand.astype(np.int64), neg_num


def metric_block(rng, n_real=None):
    """A main-path by-user block: 256 users x 640 slots, as many positives
    a user as a Foodcom test user holds (8-16) and about 500 negatives;
    with `n_real`, the rows from n_real on are pad rows (n_pos = n_cand =
    0) that score user 0's first slot."""
    b, c = METRIC_BLOCK
    n_pos = rng.integers(*FOODCOM_SCALE["test_per_user"], b)
    n_cand = n_pos + METRIC_NEG - rng.integers(0, 4, b)
    scores = rng.standard_normal((b, c)).astype(np.float32)
    if n_real is not None:
        n_pos[n_real:] = n_cand[n_real:] = 0
        scores[n_real:] = scores[0, 0]
    return scores, n_pos, n_cand, METRIC_NEG


def phase_by_user_metrics(torch, kernels):
    """The by-user metrics kernel (`evaluator.by_user_metrics` on the card)
    against the plain path on the card, bit for bit, each twice: at the
    main path's block, on the last padded block of the Foodcom test users
    and on the edge cases; then its time at the main path's block beside
    its byte bound (the block's scores) and the plain path's."""
    from foodrec_tpu_torch.engine import evaluator

    rng = np.random.default_rng(SEED)
    cases = {"main 256x640": metric_block(rng),
             "last padded block": metric_block(
                 rng, METRIC_USERS % METRIC_BLOCK[0])}
    cases.update((name, by_user_case(name)) for name in BY_USER_CASES)
    before = kernels.launches["by_user_metrics"]
    on_card = {}
    for name, (s, p, n, neg) in cases.items():
        s, p, n = on_card[name] = tuple(
            torch.from_numpy(a).cuda() for a in (s, p, n))
        runs = [evaluator.by_user_metrics(s, p, n, neg) for _ in "12"]
        want = evaluator.by_user_metrics_plain(s, p, n, neg)
        torch.cuda.synchronize()
        for k, w in want.items():
            w = w.view(torch.int32)
            for got in runs:
                g = got[k].contiguous().view(torch.int32)
                if not torch.equal(g, w):
                    row = int((g != w).nonzero()[0])
                    raise AssertionError(
                        f"by_user_metrics {name} {k}: row {row} kernel "
                        f"{float(got[k][row])!r} plain "
                        f"{float(want[k][row])!r}")
        log(f"[3 metrics] {name}: B={s.shape[0]} C={s.shape[1]} n_pos "
            f"{int(p.min())}-{int(p.max())} n_cand {int(n.min())}-"
            f"{int(n.max())}: auc, recall@10/20, ndcg@10/20 bitwise equal "
            f"to plain, bitwise repeat")
    launches = kernels.launches["by_user_metrics"] - before
    if launches != 2 * len(cases):
        raise AssertionError(f"by_user_metrics: {launches} launches for "
                             f"{2 * len(cases)} calls")
    s, p, n = on_card["main 256x640"]

    def kernel():
        return evaluator.by_user_metrics(s, p, n, METRIC_NEG)

    def plain():
        return evaluator.by_user_metrics_plain(s, p, n, METRIC_NEG)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    ms = cuda_time_ms(kernel, flush)
    warm_ms, host_ms = warm_time_ms(kernel)
    plain_ms = cuda_time_ms(plain, flush, reps=20)
    plain_warm_ms, plain_host_ms = warm_time_ms(plain, reps=20)
    bound_ms = s.numel() * s.element_size() / HBM_BYTES_PER_S * 1e3
    launches = kernels.launches["by_user_metrics"] - before
    log(f"[3 metrics] times at {METRIC_BLOCK[0]}x{METRIC_BLOCK[1]}: kernel "
        f"{ms * 1e3:.2f} us clean flush, {warm_ms * 1e3:.2f} us warm, host "
        f"{host_ms * 1e3:.2f} us a call; plain {plain_ms * 1e3:.1f} us "
        f"clean flush, {plain_warm_ms * 1e3:.1f} us warm, host "
        f"{plain_host_ms * 1e3:.1f} us a call; bound (the block's "
        f"{s.numel() * 4 / 1e3:.0f} KB) {bound_ms * 1e3:.3f} us; "
        f"by_user_metrics launches {launches}")
    return dict(ms=ms, warm_ms=warm_ms, host_ms=host_ms, plain_ms=plain_ms,
                plain_warm_ms=plain_warm_ms, plain_host_ms=plain_host_ms,
                bound_ms=bound_ms, bound_by="bytes",
                check_and_timing_launches=launches, cases=sorted(cases),
                block=list(METRIC_BLOCK))


def propagators(model):
    """{attribute name: Propagator} of a model."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    return {n: m for n, m in model.named_children()
            if isinstance(m, Propagator)}


def swap_propagators(model, impl):
    """Replace every propagator of the model by an `impl` one over the same
    adjacency; returns the previous ones, for `restore_propagators`."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    old = propagators(model)
    for name, prop in old.items():
        setattr(model, name, Propagator(prop.adj, impl=impl,
                                        device=model.device))
    return old


def restore_propagators(model, old):
    for name, prop in old.items():
        setattr(model, name, prop)


def ensure_dataset():
    """The Foodcom-scale synthetic under DATA_ROOT, generated once."""
    from foodrec_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    base = os.path.join(DATA_ROOT, DATASET)
    if not os.path.isfile(os.path.join(base, "processed_dataset",
                                       "_GEN_COMPLETE")):
        synthetic.generate(base, **FOODCOM_SCALE)
        log(f"[4 serve] generated {DATASET} in {time.perf_counter() - t0:.1f} s")


def phase_serving(torch, kernels, spmm):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    ensure_dataset()
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
    restore_propagators(model, kernel_props)
    emb_err = max(check_close("eval_cache users", user_k, user_p),
                  check_close("eval_cache items", item_k, item_p))
    log(f"[4 serve] eval_cache kernel vs segment max|d|={emb_err:.3e}")

    # the main path, counted: by-user eval on valid and test, top-k requests
    trainer = Trainer(cfg, model)
    reset_launches(kernels)
    n_caches = 0
    results = {}
    for split, es in (("valid", dd.eval_valid), ("test", dd.eval_test)):
        t0 = time.perf_counter()
        metrics = trainer.evaluate(es, is_test=split == "test")
        secs = time.perf_counter() - t0
        n_caches += 1
        results[split] = metrics
        check_unit_metrics(metrics, split)
        log(f"[4 serve] evaluate({split}): {json.dumps(metrics)} "
            f"users={es.n_users} {secs:.3f} s {es.n_users / secs:.0f} users/s")
    users = np.arange(TOPK_USERS)
    with torch.no_grad():
        cache = model.eval_cache()
        n_caches += 1
        top = full_sort_topk(
            lambda u, i: model.score_items(cache, u, i), users,
            dd.n_items, TOPK_K, device=model.device)
    # one by_user_metrics launch a block of users
    block = trainer._eval_batch()
    metrics_launches = {
        f"serve evaluate {split}": -(-es.n_users // block)
        for split, es in (("valid", dd.eval_valid), ("test", dd.eval_test))}
    got = kernels.launches["by_user_metrics"]
    log(f"[4 serve] main path: {got} by_user_metrics launches over "
        f"evaluate(valid) and evaluate(test), blocks of {block} users")
    if got != sum(metrics_launches.values()):
        raise AssertionError(f"expected {metrics_launches} by_user_metrics "
                             f"launches, got {got}")
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
                metrics_launches=metrics_launches, cfg=cfg, data=data,
                model=model)


def profile_breakdown(torch, fn, tag, what, top=8):
    """Where one call of fn() spends device time: torch.profiler's device
    time by kernel (memcpy and memset included), and the device's busy share
    of the wall time. Returns (wall us, busy us, [(device us, count, name)]
    by device time), or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels, memcpy and memset; not the ranges that user
    # annotations such as Optimizer.step record on the device's timeline
    ops = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("Optimizer.")), reverse=True)
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
    return wall_us, busy_us, ops


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


def loss_and_grads(torch, model, batch, generator=None):
    model.zero_grad(set_to_none=True)
    parts = model.calculate_loss(*batch, generator=generator)
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
    reset_launches(kernels)
    t0 = time.perf_counter()
    parts = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
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
    check_unit_metrics(metrics, "valid")
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
                busy_us=None if prof is None else prof[1], metrics=metrics)


def phase_backward_times(torch, spmm, graphs):
    """The backward launch (the kernel on A^T) by CUDA events, under the
    clean flush and (kernel) the dirty one, beside the plain `segment`
    backward and torch.sparse.mm on A^T."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
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
            launches_per_train_step=g.get("hops", 0),
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
            bytes=n_bytes, bf16_ms=b_ms, ms_dirty_flush=k_dirty,
            symmetric=adj.symmetric)
        log(f"[6 times] backward {name}: n={n} nnz={nnz} d={d} kernel on A^T "
            f"{k_ms * 1e3:.2f} us (dirty flush {k_dirty * 1e3:.2f}, bf16 mode "
            f"{b_ms * 1e3:.2f}), plain "
            f"segment backward {p_ms * 1e3:.2f} us, torch.sparse.mm(A^T) "
            f"{l_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({n_bytes / 1e6:.2f} MB), {bound_ms / k_ms:.3f} of bound, "
            f"{g.get('hops', 0)} launches per train step")
    return per_graph


def check_unit_metrics(metrics, what):
    vals = np.array(list(metrics.values()))
    if not (np.isfinite(vals).all() and (vals >= 0).all()
            and (vals <= 1).all()):
        raise AssertionError(f"{what} metrics out of range: {metrics}")


def reset_launches(kernels):
    for k in kernels.launches:
        kernels.launches[k] = 0


def spmm_launches(launches):
    """The SpMM's counts of a launches dict: forward and gradient."""
    return {k: launches[k] for k in ("spmm_csr", "spmm_csr_bwd")}


def zoo_hops(model):
    """{propagator: hops per forward} of a phase 7 or phase 11 model."""
    name = type(model).__name__
    if name in ("LightGCN", "BM3"):
        return {"prop": model.n_layers}
    if name == "FGCN":
        agg = len(model.layers) - 1
        return {"ii_prop": model.n_layers, "ir_prop": agg, "ru_prop": agg}
    if name == "SCHGN":
        return {"gcn_prop": 1}
    if name == "CIKM_Model":
        return {"ri_prop": model.n_layers, "ui_prop": model.ui_layers}
    return {"ingre_prop": model.n_ri_layers, "image_prop": model.n_ri_layers,
            "text_prop": model.n_ri_layers, "ui_prop": model.n_ui_layers}


def zoo_graphs(torch, kernels, spmm, model, tag, rng):
    """Log every propagator of the model and the impl `auto` gave it; hold
    the kernel against plain on each kernel-routed one (forward, f32 and
    bf16, and the gradient through SpmmCSR, A^T's own tables where A is not
    symmetric), bitwise repeat. Returns (graphs for the timed phases,
    kernel hops a forward)."""
    name = type(model).__name__
    hops = zoo_hops(model)
    props = propagators(model)
    if set(hops) != set(props):
        raise AssertionError(f"{name}: propagators {sorted(props)}")
    graphs, kernel_hops = {}, 0
    for pname, prop in props.items():
        adj = prop.adj
        plan = "no plan"
        if prop.impl == "kernel":
            plan = f"items={prop.plan.n_items} cut_rows={prop.plan.n_fix}"
            if not adj.symmetric:
                plan += (f", A^T items={prop.t_plan.n_items} "
                         f"cut_rows={prop.t_plan.n_fix}")
        log(f"[{tag}] {pname}: impl={prop.impl} n={adj.n_nodes} "
            f"nnz={adj.nnz} max_deg={adj.max_degree} "
            f"symmetric={adj.symmetric} {plan}, {hops[pname]} hops")
        if prop.impl != "kernel":
            continue
        kernel_hops += hops[pname]
        key = f"{name}.{pname}"
        x = torch.from_numpy(rng.standard_normal(
            (adj.n_nodes, model.embedding_size)).astype(np.float32)).cuda()
        segment = spmm.Propagator(adj, impl="segment", device=model.device)
        with torch.no_grad():
            err = check_close(f"{key} Propagator", prop(x), segment(x))
        errs = kernel_vs_plain(torch, kernels, spmm, key, prop.csr(), x)
        grad_err = spmm_grad_check(torch, spmm, key, adj,
                                   model.embedding_size, rng, kernel=prop,
                                   segment=segment, tag=tag)
        log(f"[{tag}] {key}: kernel vs plain max|d| f32 {errs[0]:.3e} bf16 "
            f"{errs[1]:.3e} (Propagator vs segment {err:.3e}) "
            f"bitwise-repeat=ok")
        graphs[key] = dict(prop=prop, segment=segment, x=x, err=max(errs),
                           grad_err=grad_err, hops=hops[pname],
                           main_path=False)
    return graphs, kernel_hops


def zoo_paths(torch, model, cfg, batches, tag):
    """eval_cache and one calculate_loss gradient through the kernel and
    through `segment` at the same parameters and dropout draws; and the
    loss parts of COMPARE_STEPS Adam steps through each path on the same
    batches, each trainer's generator seeded alike. Returns the gradient's
    max|d|."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    name = type(model).__name__
    cache_k = model.eval_cache()
    kernel_props = swap_propagators(model, "segment")
    cache_p = model.eval_cache()
    restore_propagators(model, kernel_props)
    emb_err = max(check_close(f"{name} eval_cache table {i}", a, b)
                  for i, (a, b) in enumerate(zip(cache_k, cache_p)))

    def grads(path_model):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        return loss_and_grads(torch, path_model, batches[0], gen)

    parts_k, grads_k = grads(model)
    kernel_props = swap_propagators(model, "segment")
    parts_p, grads_p = grads(model)
    restore_propagators(model, kernel_props)
    model.zero_grad(set_to_none=True)
    check_close(f"{name} loss parts", parts_k, parts_p)
    grad_err = max(check_close(f"{name} grad {k}", g, grads_p[k])
                   for k, g in grads_k.items())
    log(f"[{tag}] eval_cache kernel vs segment max|d|={emb_err:.3e}; "
        f"calculate_loss {parts_k.tolist()}, {len(grads_k)} gradient "
        f"leaves within the bar, max|d| {grad_err:.3e}")

    mk, ms = copy.deepcopy(model), copy.deepcopy(model)
    swap_propagators(ms, "segment")
    tk, ts = Trainer(cfg, mk), Trainer(cfg, ms)
    traj = []
    for batch in batches:
        pk, ps = tk.train_steps([batch]), ts.train_steps([batch])
        traj.append(((pk - ps).abs() / ps.abs()).cpu().numpy())
    traj = np.array(traj)
    worst = traj.max(axis=0)
    log(f"[{tag}] {len(batches)} Adam steps through each path: worst "
        f"relative loss-part difference {[float(f'{w:.3e}') for w in worst]}"
        f", by step {[float(f'{r:.2e}') for r in traj.max(axis=1)]}")
    if not (worst <= ZOO_TRAJECTORY_TOL[name]).all():
        raise AssertionError(f"{name}: trajectories differ by {worst}, bars "
                             f"{ZOO_TRAJECTORY_TOL[name]}")
    return grad_err


def chunk_scores(torch, model, cache, users):
    """[U, n_items] scores of one full_sort_topk user block, scored in the
    item chunks full_sort_topk scores it in (SCHGN's faithful interleave
    makes a score depend on its block); never the whole catalog at once."""
    from foodrec_tpu_torch.engine.topk_evaluator import item_chunks

    u = torch.as_tensor(users).cuda()
    return torch.cat([model.score_items(cache, u, items)[:, valid].cpu()
                      for items, valid in item_chunks(model.n_items,
                                                      TOPK_CHUNK, "cuda")], 1)


def zoo_topk(torch, model, tag):
    """full_sort_topk for TOPK_USERS users (one block) through the kernel,
    timed with its peak device memory, against the plain path: equal up to
    swaps of scores no further apart than twice the largest score
    difference between the two paths, both scored chunk by chunk. Returns
    (s, peak GiB)."""
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    users = np.arange(TOPK_USERS)

    def top(cache):
        return full_sort_topk(lambda u, i: model.score_items(cache, u, i),
                              users, model.n_items, TOPK_K,
                              user_batch=TOPK_USERS, item_chunk=TOPK_CHUNK,
                              device=model.device)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache = model.eval_cache()
        top_k = top(cache)
        topk_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        kernel_props = swap_propagators(model, "segment")
        cache_p = model.eval_cache()
        restore_propagators(model, kernel_props)
        top_p = top(cache_p)
        scores = chunk_scores(torch, model, cache, users)
        scores_p = chunk_scores(torch, model, cache_p, users)
    if top_k.shape != (TOPK_USERS, TOPK_K):
        raise AssertionError(f"top-k shape {tuple(top_k.shape)}")
    noise = float((scores - scores_p).abs().max())
    gap = float((scores_p.gather(1, top_k) - scores_p.gather(1, top_p)).abs()
                .max())
    if not gap <= 2 * noise:
        raise AssertionError(f"top-k differs from plain by score gap {gap} "
                             f"(path difference {noise})")
    same = float((top_k == top_p).float().mean())
    log(f"[{tag}] full_sort_topk {TOPK_USERS} users k={TOPK_K} (item chunks "
        f"of {TOPK_CHUNK}): {topk_s:.3f} s with its eval_cache, peak device "
        f"memory {peak_gb:.2f} GiB; {same:.4f} of slots equal, score gap of "
        f"swaps {gap:.3e} (paths differ by up to {noise:.3e})")
    return topk_s, peak_gb


def schgn_full_sort_predict(torch, kernels, model, tag):
    """SCHGN.full_sort_predict on one block of TOPK_USERS users against
    every item, its launches counted (one fresh _gcn()), held against
    score_items over the same block and all items from a fresh eval_cache:
    bitwise, else within the bar. Returns (s, launches, bitwise)."""
    users = torch.arange(TOPK_USERS, device="cuda")
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    scores = model.full_sort_predict(users)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
    want = {"spmm_csr": model_hops(model), "spmm_csr_bwd": 0}
    if launches != want:
        raise AssertionError(f"full_sort_predict: expected {want} launches, "
                             f"got {launches}")
    if scores.shape != (TOPK_USERS, model.n_items) or not bool(
            scores.isfinite().all()):
        raise AssertionError(f"full_sort_predict: shape "
                             f"{tuple(scores.shape)} or a score not finite")
    block = model.score_items(model.eval_cache(), users,
                              torch.arange(model.n_items, device="cuda"))
    bitwise = bool(torch.equal(scores, block))
    err = 0.0 if bitwise else check_close("full_sort_predict", scores, block)
    log(f"[{tag}] full_sort_predict {TOPK_USERS} users x {model.n_items} "
        f"items: {predict_s:.3f} s with its _gcn(), launches {launches}; "
        f"against score_items over the block: bitwise {bitwise} (max|d| "
        f"{err:.3e})")
    del scores, block
    torch.cuda.empty_cache()
    return predict_s, launches, bitwise


def phase_zoo_model(torch, kernels, spmm, name):
    """Phase 7 for one model at Foodcom scale with its shipped config."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    tag = f"7 {name}"
    t0 = time.perf_counter()
    cfg = Config(name, DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED,
        "neg_sample_num": FOODCOM_SCALE["neg_num"],
        **ZOO_OVERRIDES.get(name, {})})
    derive_data_paths(cfg, DATASET)
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = get_model(name)(
        cfg, data, generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[{tag}] device={cfg['device']} embedding={cfg['embedding_size']} "
        f"batch={cfg['train_batch_size']} lr={cfg['learning_rate']} "
        f"parameters={sum(p.numel() for p in model.parameters())}; load "
        f"{t_load:.1f} s, model {time.perf_counter() - t0:.1f} s")

    graphs, hops = zoo_graphs(torch, kernels, spmm, model, tag,
                              np.random.default_rng(SEED + 7))
    log(f"[{tag}] {hops} kernel hops a forward (auto's choice)")
    if name == "SCHGN":
        # `auto` routes the graph to the kernel, and every calorie level's
        # row of A^T is cut: the backward of each train step runs the fix-up
        # kernel
        if model.gcn_prop.impl != "kernel":
            raise AssertionError(f"gcn_prop.impl={model.gcn_prop.impl}")
        cut = model.gcn_prop.t_plan.n_fix
        log(f"[{tag}] gcn_prop A^T: {cut} cut rows, {model.n_health} "
            "calorie levels")
        if cut != model.n_health:
            raise AssertionError(f"A^T cut {cut} rows, expected "
                                 f"{model.n_health}")
    batches = draw_batches(torch, dd, COMPARE_STEPS, cfg["train_batch_size"],
                           SEED + 1)
    model_grad_err = zoo_paths(torch, model, cfg, batches, tag)
    del batches
    torch.cuda.empty_cache()

    # training: one full epoch from the seed's parameters, counted
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
    reset_launches(kernels)
    t0 = time.perf_counter()
    parts = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_launches = spmm_launches(kernels.launches)
    del model.calculate_loss
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = len(step_parts)
    if n_steps != trainer.n_batches:
        raise AssertionError(f"{n_steps} steps, expected {trainer.n_batches}")
    log(f"[{tag}] epoch: steps={n_steps} wall {epoch_s:.3f} s, "
        f"{n_steps / epoch_s:.1f} steps/s, peak device memory "
        f"{peak_gb:.2f} GiB, launches {train_launches}")
    want = {"spmm_csr": hops * n_steps, "spmm_csr_bwd": hops * n_steps}
    if train_launches != want:
        raise AssertionError(f"{name}: expected {want} launches, got "
                             f"{train_launches}")
    steps = torch.stack(step_parts).cpu().numpy()
    if not np.isfinite(steps).all():
        raise AssertionError(f"{name}: a loss part is not finite")
    first, last = steps[:LOSS_WINDOW].sum(), steps[-LOSS_WINDOW:].sum()
    log(f"[{tag}] loss parts per step, epoch mean "
        f"{(parts.cpu().numpy() / n_steps).tolist()}; first {LOSS_WINDOW} "
        f"steps sum {first:.4f}, last {LOSS_WINDOW} steps sum {last:.4f}")
    if not last < first:
        raise AssertionError(f"{name}: the loss did not fall over the epoch")
    trainer.scheduler.step()
    batches = draw_batches(torch, dd, PROFILE_STEPS, cfg["train_batch_size"],
                           SEED + 2)
    prof = profile_breakdown(torch, lambda: trainer.train_steps(batches), tag,
                             f"{PROFILE_STEPS} train steps", top=5)

    # serving: by-user eval on valid and test, one top-k block, counted
    reset_launches(kernels)
    eval_s, metrics = {}, {}
    for split, es in (("valid", dd.eval_valid), ("test", dd.eval_test)):
        t0 = time.perf_counter()
        metrics[split] = trainer.evaluate(es, is_test=split == "test")
        eval_s[split] = time.perf_counter() - t0
        check_unit_metrics(metrics[split], f"{name} {split}")
        log(f"[{tag}] evaluate({split}): {json.dumps(metrics[split])} "
            f"users={es.n_users} {eval_s[split]:.3f} s "
            f"{es.n_users / eval_s[split]:.0f} users/s")
    topk_s, topk_gb = zoo_topk(torch, model, tag)  # one eval_cache
    serve_launches = spmm_launches(kernels.launches)
    want = {"spmm_csr": 3 * hops, "spmm_csr_bwd": 0}
    log(f"[{tag}] serving: {serve_launches['spmm_csr']} spmm_csr launches "
        f"over 3 eval_cache calls")
    if serve_launches != want:
        raise AssertionError(f"{name}: expected {want} serving launches, got "
                             f"{serve_launches}")
    predict = (schgn_full_sort_predict(torch, kernels, model, tag)
               if name == "SCHGN" else None)
    return dict(graphs=graphs, hops=hops, serve=serve_launches["spmm_csr"],
                full_sort_predict=predict,
                train=train_launches, epoch_s=epoch_s, n_steps=n_steps,
                peak_gb=peak_gb, eval_s=eval_s, metrics=metrics,
                topk_s=topk_s, topk_peak_gb=topk_gb,
                busy_share=None if prof is None else prof[1] / prof[0],
                busy_us=None if prof is None else prof[1],
                grad_err=max([model_grad_err] + [g["grad_err"]
                                                 for g in graphs.values()]))


def phase_zoo(torch, kernels, spmm):
    """Phase 7 for the five models, one after another, each freed before
    the next."""
    zoo = {}
    for name in ZOO:
        zoo[name] = phase_zoo_model(torch, kernels, spmm, name)
        torch.cuda.empty_cache()
    return zoo


def phase_gate(torch):
    """The LightGCN accuracy gate of the JAX package's bench through the
    kernel: 30 epochs on the structured toy synthetic, then evaluate(test)."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    base = os.path.join(DATA_ROOT, GATE_DATASET)
    if not os.path.isfile(os.path.join(base, "processed_dataset",
                                       "_GEN_COMPLETE")):
        synthetic.generate(base, **GATE_SCALE)
    cfg = Config("LightGCN", GATE_DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED, "epochs": GATE_EPOCHS,
        "neg_sample_num": GATE_SCALE["neg_num"], "spmm_impl": "kernel"})
    derive_data_paths(cfg, GATE_DATASET)
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    model = get_model("LightGCN")(
        cfg, data, generator=torch.Generator().manual_seed(SEED))
    if model.prop.impl != "kernel":
        raise AssertionError(f"gate impl {model.prop.impl}")
    trainer = Trainer(cfg, model)
    t0 = time.perf_counter()
    for _ in range(GATE_EPOCHS):
        parts = trainer.train_epoch()
        trainer.scheduler.step()
    if not torch.isfinite(parts).all():
        raise AssertionError("gate: a loss part is not finite")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    metrics = trainer.evaluate(dd.eval_test, is_test=True)
    auc, ndcg = metrics["AUC"], metrics["NDCG@20"]
    log(f"[7 gate] LightGCN {GATE_EPOCHS} epochs on {GATE_DATASET} "
        f"({dd.n_users} users x {dd.n_items} items, {trainer.n_batches} "
        f"steps an epoch) through the kernel: AUC={auc:.4f} "
        f"NDCG@20={ndcg:.4f} (bars {GATE_AUC}, {GATE_NDCG20}); train "
        f"{train_s:.1f} s")
    if not (auc >= GATE_AUC and ndcg >= GATE_NDCG20):
        raise AssertionError(f"accuracy gate failed: AUC {auc:.4f}, "
                             f"NDCG@20 {ndcg:.4f}")
    return dict(auc=auc, ndcg20=ndcg, train_s=train_s)


def driver_cli(torch, kernels, dataset=DATASET, data_root=DATA_ROOT,
               epochs=DRIVER_EPOCHS, tag="8 driver"):
    """`python -m foodrec_tpu_torch.runner -m CIKM_Model -d FoodcomSynth
    --epochs 2` (or `dataset` under `data_root` for `epochs`), in process:
    one combination, its best checkpoint at the JAX package's name, the log
    with its BEST block, every propagator on the kernel, and 3 forward + 3
    backward launches a step plus 3 an eval_cache. Returns the run's
    trainer, test metrics, launches and times."""
    from foodrec_tpu_torch import runner
    from foodrec_tpu_torch.engine import quick_start as qs

    trainers, epoch_s, first_epoch = [], [], []
    get_trainer = qs.get_trainer

    def recording_get_trainer():
        cls = get_trainer()

        def make(*args, **kwargs):
            trainer = cls(*args, **kwargs)
            train_epoch = trainer.train_epoch

            def timed_epoch():
                if not first_epoch:
                    first_epoch.append(time.perf_counter())
                t0 = time.perf_counter()
                parts = train_epoch()
                torch.cuda.synchronize()
                epoch_s.append(time.perf_counter() - t0)
                return parts

            trainer.train_epoch = timed_epoch
            trainers.append(trainer)
            return trainer

        return make

    qs.get_trainer = recording_get_trainer
    reset_launches(kernels)
    t0 = time.perf_counter()
    try:
        hyper_tuple, valid, test = runner.main([
            "-m", "CIKM_Model", "-d", dataset, "--data_path", data_root + "/",
            "--epochs", str(epochs),
            "--neg_sample_num", str(FOODCOM_SCALE["neg_num"])])
    finally:
        qs.get_trainer = get_trainer
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)

    if len(trainers) != 1 or hyper_tuple != (SEED,):
        raise AssertionError(f"{len(trainers)} combinations, best {hyper_tuple}")
    trainer = trainers[0]
    model = trainer.model
    impls = {n: p.impl for n, p in propagators(model).items()}
    if set(impls.values()) != {"kernel"}:
        raise AssertionError(f"propagators {impls}")
    ckpts = os.listdir("ckp")
    want_ckpt = f"CIKM_Model-{dataset}-['seed']=({SEED},).pkl"
    if ckpts != [want_ckpt]:
        raise AssertionError(f"checkpoints {ckpts}, expected [{want_ckpt}]")
    (log_name,) = os.listdir("log")
    with open(os.path.join("log", log_name), encoding="utf-8") as f:
        text = f.read()
    if "█ BEST █" not in text or "Saving current best" not in text:
        raise AssertionError(f"{log_name} has no BEST block")
    check_unit_metrics(test, f"{tag} test")
    check_unit_metrics(valid, f"{tag} valid")

    n_epochs = len(trainer.train_loss_dict)
    n_evals = n_epochs // trainer.eval_step + 1  # valid evals + the test
    hops = model.n_layers + model.ui_layers
    want = {"spmm_csr": hops * (n_epochs * trainer.n_batches + n_evals),
            "spmm_csr_bwd": hops * n_epochs * trainer.n_batches}
    log(f"[{tag}] cli: {n_epochs} epochs x {trainer.n_batches} steps, "
        f"{n_evals} eval_cache calls; launches {launches} (expected {want}); "
        f"impls {impls}")
    if n_epochs != epochs or launches != want:
        raise AssertionError(f"expected {want} launches over {epochs} "
                             f"epochs, got {launches} over {n_epochs}")
    setup_s = first_epoch[0] - t0
    log(f"[{tag}] cli: wall {cli_s:.3f} s, set-up (config, data, device "
        f"arrays, model) {setup_s:.3f} s, epochs "
        f"{[round(e, 3) for e in epoch_s]} s "
        f"({trainer.n_batches / epoch_s[-1]:.1f} steps/s), best {hyper_tuple}, "
        f"checkpoint ckp/{want_ckpt}, log log/{log_name}")
    log(f"[{tag}] cli valid: {json.dumps(valid)}")
    log(f"[{tag}] cli test: {json.dumps(test)}")
    return dict(trainer=trainer, test=test, launches=launches, cli_s=cli_s,
                setup_s=setup_s, epoch_s=epoch_s, ckpt=os.path.join("ckp",
                                                                     want_ckpt))


def driver_checkpoint(torch, cli):
    """The CLI's best checkpoint into a fresh CIKM_Model: evaluate(test)
    equals the run's test metrics. Times save and load, and the size."""
    from foodrec_tpu_torch.engine import checkpoint as ckpt
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    trainer = cli["trainer"]
    cfg, data = trainer.config, trainer.model.dataset
    fresh = get_model("CIKM_Model")(
        cfg, data, generator=torch.Generator().manual_seed(SEED + 1))
    t0 = time.perf_counter()
    state = Trainer.load_checkpoint(cli["ckpt"])
    fresh.load_state_dict(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_best(fresh.state_dict(), cli["ckpt"] + ".again")
    save_s = time.perf_counter() - t0
    size = os.path.getsize(cli["ckpt"])
    metrics = Trainer(cfg, fresh).evaluate(data.device_data.eval_test,
                                           is_test=True)
    log(f"[8 driver] checkpoint {size / 2 ** 20:.1f} MiB: save {save_s:.3f} s, "
        f"load {load_s:.3f} s; reloaded evaluate(test) {json.dumps(metrics)}")
    if metrics != cli["test"]:
        raise AssertionError(f"reloaded test metrics {metrics} != the run's "
                             f"{cli['test']}")
    del fresh, state
    return dict(size_mib=size / 2 ** 20, save_s=save_s, load_s=load_s)


def driver_mg(torch, kernels, data):
    """One CIKM_Model epoch under Mirror Gradient (alpha1 1.0, alpha2 0.1,
    beta 3), counted: 3 launches each way for every pass, n_batches +
    ceil(n_batches / 3) passes."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import derive_data_paths
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg = Config("CIKM_Model", DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED,
        "neg_sample_num": FOODCOM_SCALE["neg_num"], **MG_SETTINGS}, mg=True)
    derive_data_paths(cfg, DATASET)
    model = get_model("CIKM_Model")(
        cfg, data, generator=torch.Generator().manual_seed(SEED))
    trainer = Trainer(cfg, model, mg=True)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    parts = trainer.train_epoch()
    torch.cuda.synchronize()
    mg_s = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
    n_batches = trainer.n_batches
    passes = n_batches + -(-n_batches // MG_SETTINGS["beta"])
    hops = model.n_layers + model.ui_layers
    want = {"spmm_csr": hops * passes, "spmm_csr_bwd": hops * passes}
    log(f"[8 driver] mg epoch: {n_batches} batches, {trainer.n_updates} "
        f"updates, wall {mg_s:.3f} s, {n_batches / mg_s:.1f} steps/s, "
        f"launches {launches} (expected {want}), loss parts per step "
        f"{(parts.cpu().numpy() / n_batches).tolist()}, lr after the epoch "
        f"{trainer.lr_schedule(trainer.n_updates):.6g}")
    if launches != want or trainer.n_updates != passes:
        raise AssertionError(f"mg: expected {want} launches and {passes} "
                             f"updates, got {launches}, {trainer.n_updates}")
    if not torch.isfinite(parts).all():
        raise AssertionError("mg: a loss part is not finite")
    return dict(epoch_s=mg_s, steps=n_batches, updates=passes,
                launches=launches)


def driver_full_sort(torch, kernels, trainer):
    """_valid_full_sort(test): every user over the whole catalog, k = 50,
    with the top-k CSV; against the same sweep through `segment`: the same
    ids in every slot, or swaps of scores closer than twice the two paths'
    score difference, and the same metrics."""
    from foodrec_tpu_torch.engine import topk_evaluator

    model = trainer.model
    seen = []
    evaluate = topk_evaluator.TopKEvaluator.evaluate

    def recording(self, topk_index, *args, **kwargs):
        seen.append(np.asarray(topk_index))
        return evaluate(self, topk_index, *args, **kwargs)

    topk_evaluator.TopKEvaluator.evaluate = recording
    try:
        torch.cuda.synchronize()
        reset_launches(kernels)
        t0 = time.perf_counter()
        score, result = trainer._valid_full_sort(is_test=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernels.launches["spmm_csr"]
        kernel_props = swap_propagators(model, "segment")
        _, result_p = trainer._valid_full_sort(is_test=True)
        restore_propagators(model, kernel_props)
    finally:
        topk_evaluator.TopKEvaluator.evaluate = evaluate
    top, top_p = seen
    n_users = model.dataset.num_users
    if top.shape != (n_users, 50):
        raise AssertionError(f"full-sort top-k shape {top.shape}")
    rows = np.flatnonzero((top != top_p).any(axis=1))
    gap = noise = 0.0
    if len(rows):
        with torch.no_grad():
            user_k, item_k = model.eval_cache()
            kernel_props = swap_propagators(model, "segment")
            user_p, item_p = model.eval_cache()
            restore_propagators(model, kernel_props)
            u = torch.as_tensor(rows).cuda()
            s_k, s_p = (user_k[u] @ item_k.T).cpu(), (user_p[u] @ item_p.T).cpu()
        noise = float((s_k - s_p).abs().max())
        gap = float((s_p.gather(1, torch.as_tensor(top[rows])) -
                     s_p.gather(1, torch.as_tensor(top_p[rows]))).abs().max())
        if not gap <= 2 * noise:
            raise AssertionError(f"full-sort differs from segment by score gap "
                                 f"{gap} (paths differ by {noise})")
    check_unit_metrics(result, "full_sort")
    if result != result_p:
        raise AssertionError(f"full-sort metrics {result} != segment's "
                             f"{result_p}")
    csvs = os.listdir("recommend_topk")
    with open(os.path.join("recommend_topk", csvs[0])) as f:
        header, n_rows = f.readline(), 1 + sum(1 for _ in f)
    log(f"[8 driver] full_sort test: {n_users} users x "
        f"{model.dataset.num_items} items, k=50, {secs:.3f} s, "
        f"{n_users / secs:.0f} users/s, {launches} spmm_csr launches; "
        f"{(top == top_p).mean():.6f} of slots equal to segment's "
        f"({len(rows)} rows differ, score gap of swaps {gap:.3e}, paths "
        f"differ by up to {noise:.3e}); metrics equal; score {score:.4f}; "
        f"CSV {csvs[0]} ({n_rows} lines, header {header.split()[:3]}...)")
    log(f"[8 driver] full_sort test metrics: {json.dumps(result)}")
    if n_rows != n_users + 1 or not header.startswith("id\ttop_0\t"):
        raise AssertionError(f"top-k CSV {n_rows} lines, header {header!r}")
    return dict(s=secs, users_per_s=n_users / secs, launches=launches,
                rows_differ=int(len(rows)), metrics=result)


def driver_sample(torch, kernels, trainer):
    """_valid_sample(test): each test positive among its user's 500
    negatives, against the `segment` path within 1e-6."""
    model = trainer.model
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    score, result = trainer._valid_sample(is_test=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernels.launches["spmm_csr"]
    kernel_props = swap_propagators(model, "segment")
    _, result_p = trainer._valid_sample(is_test=True)
    restore_propagators(model, kernel_props)
    worst = max(abs(result[k] - result_p[k]) for k in result)
    users, cand = trainer._sample_candidates(is_test=True)
    log(f"[8 driver] sample test: {len(users)} rows x {cand.shape[1]} "
        f"candidates, {secs:.3f} s, {launches} spmm_csr launches; max|d| "
        f"against segment {worst:.3e}; {json.dumps(result)}")
    check_unit_metrics(result, "sample")
    if list(result) != list(result_p) or not worst <= 1e-6:
        raise AssertionError(f"sampled metrics {result} vs segment's "
                             f"{result_p}")
    return dict(s=secs, rows=len(users), launches=launches, metrics=result,
                max_abs_diff_segment=worst)


def driver_studies(torch, trainer):
    """The cold, sense and health-level studies on the CLI's trained
    parameters, with the dataset's study splits loaded."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg = Config("CIKM_Model", DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED,
        "neg_sample_num": FOODCOM_SCALE["neg_num"], **STUDY_FLAGS})
    derive_data_paths(cfg, DATASET)
    t0 = time.perf_counter()
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    load_s = time.perf_counter() - t0
    model = get_model("CIKM_Model")(
        cfg, data, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(trainer.model.state_dict())
    study_trainer = Trainer(cfg, model)
    out = {}
    for name in ("cold_start_study", "sense_study", "health_level_study"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = getattr(study_trainer, name)()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        metrics = {k: v for k, v in result.items()
                   if not k.endswith("predictions")}
        for split, m in metrics.items():
            check_unit_metrics(m, f"{name} {split}")
        out[name] = dict(s=secs, metrics=metrics)
        log(f"[8 driver] {name}: {secs:.3f} s; {json.dumps(metrics)}")
    log(f"[8 driver] studies: splits loaded in {load_s:.3f} s "
        f"(cold {len(data.cold_users)}, warm {len(data.warm_users)}, sense "
        f"{len(data.sense_users)}, unsense {len(data.unsense_users)} users)")
    return out


def driver_resume(torch, data):
    """A 2-epoch fit with save_state_every: 1 (each state kept), then a fit
    resumed from epoch 0's state: the final parameters against the run that
    was not stopped, bitwise; where not, the leaves whose gradient is not
    repeatable name the op, and the resumed epoch's loss is held to
    TRAJECTORY_TOL's mf bar."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import derive_data_paths
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    def config(**extra):
        cfg = Config("CIKM_Model", DATASET, {
            "data_path": DATA_ROOT + "/", "seed": SEED,
            "neg_sample_num": FOODCOM_SCALE["neg_num"], "epochs": 2,
            "ckp_root": "ckp_resume/", **extra})
        derive_data_paths(cfg, DATASET)
        return cfg

    def model(cfg, seed):
        return get_model("CIKM_Model")(
            cfg, data, generator=torch.Generator().manual_seed(seed))

    cfg = config(save_state_every=1)
    straight = Trainer(cfg, model(cfg, SEED))
    states, save_s = [], []
    save = straight._save_state

    def keep_each(path, epoch, cur_step):
        t0 = time.perf_counter()
        save(path, epoch, cur_step)
        save_s.append(time.perf_counter() - t0)
        states.append(f"{path}.epoch{epoch}")
        os.replace(path, states[-1])

    straight._save_state = keep_each
    straight.fit(data, hyper_tuple=(SEED,))
    size = os.path.getsize(states[0])

    resumed = Trainer(config(resume_from=states[0]), model(cfg, SEED + 1))
    resume = resumed._resume
    load_s = []

    def timed_resume(path):
        t0 = time.perf_counter()
        out = resume(path)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return out

    resumed._resume = timed_resume
    resumed.fit(data, hyper_tuple=(SEED,))
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    differ = {k: float((a[k] - b[k]).abs().max()) for k in a
              if not torch.equal(a[k], b[k])}
    loss_gap = abs(resumed.train_loss_dict[1] / straight.train_loss_dict[1] - 1)
    log(f"[8 driver] resume: state {size / 2 ** 20:.1f} MiB, save "
        f"{[round(x, 3) for x in save_s]} s, load {load_s[0]:.3f} s; epoch 1 "
        f"loss {straight.train_loss_dict[1]!r} straight, "
        f"{resumed.train_loss_dict[1]!r} resumed; "
        f"{len(a) - len(differ)} of {len(a)} leaves bitwise equal")
    nondeterministic = []
    if differ:
        # which gradients are not repeatable: the same batch twice from the
        # same parameters
        batch = draw_batches(torch, data.device_data, 1,
                             cfg["train_batch_size"], SEED + 3)[0]
        probe = resumed.model
        probe.attn_dropout = 0.0
        _, g1 = loss_and_grads(torch, probe, batch)
        g1 = {k: g.clone() for k, g in g1.items()}
        _, g2 = loss_and_grads(torch, probe, batch)
        nondeterministic = sorted(k for k in g1 if not torch.equal(g1[k], g2[k]))
        log(f"[8 driver] resume not bitwise: max|d| by leaf {differ}; "
            f"leaves whose gradient differs between two runs of one step: "
            f"{nondeterministic}; epoch 1 loss relative gap {loss_gap:.3e} "
            f"(bar {TRAJECTORY_TOL[0]})")
        if not loss_gap <= TRAJECTORY_TOL[0]:
            raise AssertionError(f"resumed epoch loss differs by {loss_gap}")
    else:
        log("[8 driver] resume: the final parameters equal the run that was "
            "not stopped, bitwise")
    return dict(bitwise=not differ, max_abs_diff=differ,
                nondeterministic_grads=nondeterministic, state_mib=size / 2 ** 20,
                save_s=save_s, load_s=load_s[0], epoch1_loss_gap=loss_gap)


def phase_driver(torch, kernels):
    """Phase 8: the experiment driver at Foodcom scale, run with
    DRIVER_ROOT as the working directory (restored after)."""
    import shutil

    shutil.rmtree(DRIVER_ROOT, ignore_errors=True)
    os.makedirs(DRIVER_ROOT)
    cwd = os.getcwd()
    os.chdir(DRIVER_ROOT)
    try:
        cli = driver_cli(torch, kernels)
        trainer = cli["trainer"]
        data = trainer.model.dataset
        out = dict(cli={k: v for k, v in cli.items() if k != "trainer"})
        out["checkpoint"] = driver_checkpoint(torch, cli)
        out["full_sort"] = driver_full_sort(torch, kernels, trainer)
        out["sample"] = driver_sample(torch, kernels, trainer)
        out["studies"] = driver_studies(torch, trainer)
        del trainer, cli
        torch.cuda.empty_cache()
        out["mg"] = driver_mg(torch, kernels, data)
        torch.cuda.empty_cache()
        out["resume"] = driver_resume(torch, data)
    finally:
        os.chdir(cwd)
    return out


# phase 9: the training and data options, through the kernel
OPTION_STEPS = 20     # steps of the learner comparisons
OPTION_TOL = 1e-5     # their loss parts, relative, at every step
HEALTH_FLAGS = {"use_health_level_multi_hot": False, "use_health_level": True,
                "load_RecipeHealth_graph": True, "health_neg_sample": True,
                "exact_final_batch": False}
TRACE_ROOT = os.path.join(ROOT, "build", "trace")


def option_config(name, **extra):
    """A Foodcom-scale config of `name` through the kernel, weights seed
    SEED, with `extra` set."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import derive_data_paths

    cfg = Config(name, DATASET, {
        "data_path": DATA_ROOT + "/", "seed": SEED,
        "neg_sample_num": FOODCOM_SCALE["neg_num"], "spmm_impl": "kernel",
        **ZOO_OVERRIDES.get(name, {}), **extra})
    derive_data_paths(cfg, DATASET)
    return cfg


def option_model(torch, cfg, data):
    from foodrec_tpu_torch.models import get_model

    return get_model(cfg["model"])(
        cfg, data, generator=torch.Generator().manual_seed(SEED))


def counted_epoch(torch, kernels, trainer, tag, what):
    """One train_epoch with the launch counts set to 0 just before it and
    read just after, its batches and loss parts recorded; asserts the
    model's kernel hops a step each way and finite loss parts. Returns
    (wall s, launches, batches, [n_steps, n_parts] loss parts, peak
    GiB)."""
    model = trainer.model
    hops = (model.n_layers + model.ui_layers
            if type(model).__name__ == "CIKM_Model"
            else sum(zoo_hops(model).values()))
    seen, step_parts = [], []
    train_steps = trainer.train_steps

    def recording(batches):
        total = None
        for batch in batches:
            seen.append(batch)
            step_parts.append(train_steps([batch]))
            total = step_parts[-1] if total is None else total + step_parts[-1]
        return total

    trainer.train_steps = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    t0 = time.perf_counter()
    trainer.train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
    del trainer.train_steps
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(seen)
    want = {"spmm_csr": hops * n, "spmm_csr_bwd": hops * n}
    log(f"[{tag}] {what}: steps={n} wall {wall:.3f} s, {n / wall:.1f} "
        f"steps/s, peak device memory {peak_gb:.2f} GiB, launches "
        f"{launches}")
    if n != trainer.n_batches or launches != want:
        raise AssertionError(f"{tag}: {n} steps (expected "
                             f"{trainer.n_batches}), launches {launches} "
                             f"(expected {want})")
    parts = torch.stack(step_parts).cpu().numpy()
    if not np.isfinite(parts).all():
        raise AssertionError(f"{tag}: a loss part is not finite")
    return wall, launches, seen, parts, peak_gb


def options_health(torch, kernels):
    """(a) CIKM_Model with the scalar health level, health-stratified
    negatives and the padded final batch: one full epoch, every batch at
    512 rows, the tail's wrapped rows weighted 0, and the health
    negatives' invariants: an item of the positive's health level for a
    user of the sample set, of the train list for the others, outside the
    user's positives."""
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.data.sampling import is_excluded
    from foodrec_tpu_torch.engine.trainer import Trainer

    tag = "9 health"
    cfg = option_config("CIKM_Model", **HEALTH_FLAGS)
    t0 = time.perf_counter()
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    model = option_model(torch, cfg, data)
    trainer = Trainer(cfg, model)
    log(f"[{tag}] load {time.perf_counter() - t0:.1f} s; health head width "
        f"{model.health_mlp['l2']['w'].shape[1]} (num_health_level "
        f"{data.num_health_level}), buckets {dd.health_bucket_items.shape}, "
        f"{int(dd.health_in_sample.sum())} users in the sample set, "
        f"{len(dd.train_items_arr)} train items")
    if model.health_mlp["l2"]["w"].shape[1] != data.num_health_level:
        raise AssertionError("health head width")
    wall, launches, seen, parts, peak = counted_epoch(
        torch, kernels, trainer, tag, "padded epoch with health negatives")
    bs = trainer.train_batch_size
    weights = torch.cat([b[3]["weight"] for b in seen])
    n_pad = len(weights) - trainer.n_train
    if {len(b[0]) for b in seen} != {bs} or int(weights.sum()) != \
            trainer.n_train or int((seen[-1][3]["weight"] == 0).sum()) != n_pad:
        raise AssertionError(f"{tag}: padded batches or weights")
    u = torch.cat([b[0] for b in seen])
    pos = torch.cat([b[1] for b in seen])
    hn = torch.cat([b[3]["health_neg"] for b in seen])
    level, buckets, in_sample, train_items = trainer._health
    lens = (buckets >= 0).sum(1)
    from_bucket = in_sample[u] & (lens[level[pos].long()] > 0)
    in_train = torch.zeros(dd.num_items, dtype=torch.bool, device="cuda")
    in_train[train_items.long()] = True
    same_level = level[hn] == level[pos]
    bad_bucket = int((from_bucket & ~same_level).sum())
    bad_uniform = int((~from_bucket & ~in_train[hn]).sum())
    excluded = int(is_excluded(trainer._excl, u, hn).sum())
    log(f"[{tag}] {len(seen)} steps of {bs} rows, the last with {n_pad} "
        f"zero-weight rows; health negatives: {int(from_bucket.sum())} from "
        f"the positive's bucket ({bad_bucket} of another level), "
        f"{int((~from_bucket).sum())} uniform over the train items "
        f"({bad_uniform} outside them), {excluded} among the user's "
        f"positives; loss parts per step, epoch mean "
        f"{parts.mean(0).tolist()}")
    if bad_bucket or bad_uniform or excluded:
        raise AssertionError(f"{tag}: health negative invariants")
    return dict(epoch_s=wall, steps=len(seen), steps_per_s=len(seen) / wall,
                pad_rows=n_pad, peak_gb=peak, launches=launches)


def options_learners(torch, kernels, data):
    """(c) OPTION_STEPS steps of sgd, adagrad and rmsprop on CIKM_Model
    through the kernel, dropout 0, the kernel path's launches counted. At
    every step the `segment` path's loss parts at the kernel path's
    parameters must lie within OPTION_TOL; a second trainer that runs the
    same batches through `segment` on its own parameters is held to phase
    6's TRAJECTORY_TOL: two float32 runs of a learner part where the
    training amplifies rounding."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    tag = "9 learners"
    out = {}
    batches = draw_batches(torch, data.device_data, OPTION_STEPS, 512,
                           SEED + 10)
    for learner in ("sgd", "adagrad", "rmsprop"):
        cfg = option_config("CIKM_Model", learner=learner)
        mk = option_model(torch, cfg, data)
        mk.attn_dropout = 0.0
        ms, mp = copy.deepcopy(mk), copy.deepcopy(mk)
        swap_propagators(ms, "segment")
        swap_propagators(mp, "segment")
        impls = {m: sorted({p.impl for p in propagators(m).values()})
                 for m in (mk, ms, mp)}
        if list(impls.values()) != [["kernel"], ["segment"], ["segment"]]:
            raise AssertionError(f"{tag}: impls {list(impls.values())}")
        tk, ts = Trainer(cfg, mk), Trainer(cfg, ms)
        same, free, parts_k = [], [], []
        hops = mk.n_layers + mk.ui_layers
        launches = {"spmm_csr": 0, "spmm_csr_bwd": 0}
        for batch in batches:
            mp.load_state_dict(mk.state_dict())
            with torch.no_grad():
                pp = torch.stack(mp.calculate_loss(*batch))
            reset_launches(kernels)
            pk = tk.train_steps([batch])
            torch.cuda.synchronize()
            step = spmm_launches(kernels.launches)
            if step != {"spmm_csr": hops, "spmm_csr_bwd": hops}:
                raise AssertionError(f"{tag}: {learner} launches {step}")
            for k in launches:
                launches[k] += step[k]
            ps = ts.train_steps([batch])
            same.append(((pk - pp).abs() / pp.abs()).cpu().numpy())
            free.append(((pk - ps).abs() / ps.abs()).cpu().numpy())
            parts_k.append(pk.cpu().numpy())
        same, free = np.array(same).max(axis=0), np.array(free).max(axis=0)
        log(f"[{tag}] {learner} ({type(tk.optimizer).__name__}): "
            f"{OPTION_STEPS} steps through the kernel, {launches}; segment "
            f"at the same parameters, worst relative loss-part difference "
            f"{same.tolist()}; segment on its own parameters "
            f"{free.tolist()}; kernel loss parts first / last step "
            f"{parts_k[0].tolist()} / {parts_k[-1].tolist()}")
        if not (same <= OPTION_TOL).all():
            raise AssertionError(f"{tag}: {learner} loss parts at the same "
                                 f"parameters differ by {same}")
        if not (free <= TRAJECTORY_TOL).all():
            raise AssertionError(f"{tag}: {learner} trajectories differ by "
                                 f"{free}, bars {TRAJECTORY_TOL}")
        out[learner] = dict(same_params_worst_rel=same.tolist(),
                            trajectory_worst_rel=free.tolist(),
                            launches=launches)
        del mk, ms, mp, tk, ts
        torch.cuda.empty_cache()
    return out


def options_frozen(torch, kernels, data, trainable):
    """(d) One full epoch each of CIKM_Model and BM3 with
    freeze_modality_tables: the tables out of the optimizer (n_items x
    (2048 + 512) fewer parameters), beside the trainable epochs of phases
    6 and 7 of this run (`trainable`: {name: (epoch s, peak GiB, device
    busy us of their 20-step profile)}), with a profile of the same 20
    steps."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    tag = "9 frozen"
    out = {}
    for name in ("CIKM_Model", "BM3"):
        counts = {}
        for frozen in (False, True):
            cfg = option_config(name, freeze_modality_tables=frozen)
            model = option_model(torch, cfg, data)
            counts[frozen] = sum(p.numel() for g in Trainer(
                cfg, model).optimizer.param_groups for p in g["params"])
            if not frozen:
                del model
                torch.cuda.empty_cache()
        dd = data.device_data
        fewer = counts[False] - counts[True]
        want = dd.n_items * (dd.img.shape[1] + dd.txt.shape[1])
        trainer = Trainer(cfg, model)
        wall, launches, _, _, peak = counted_epoch(
            torch, kernels, trainer, tag, f"{name} frozen epoch")
        trainer.scheduler.step()
        batches = draw_batches(torch, dd, PROFILE_STEPS,
                               trainer.train_batch_size, SEED + 2)
        prof = profile_breakdown(
            torch, lambda: trainer.train_steps(batches), tag,
            f"{PROFILE_STEPS} frozen {name} steps", top=5)
        busy = None if prof is None else prof[1]
        log(f"[{tag}] {name}: optimizer parameters {counts[True]} "
            f"({fewer} fewer than trainable, expected {want}); epoch "
            f"{wall:.3f} s, peak {peak:.2f} GiB, device busy {busy} us "
            f"over {PROFILE_STEPS} steps, against the trainable epoch's "
            f"{trainable[name][0]:.3f} s, {trainable[name][1]:.2f} GiB and "
            f"{trainable[name][2]} us in this run")
        if fewer != want:
            raise AssertionError(f"{tag}: {name} {fewer} parameters fewer")
        out[name] = dict(epoch_s=wall, trainable_epoch_s=trainable[name][0],
                         peak_gb=peak, trainable_peak_gb=trainable[name][1],
                         busy_us_20_steps=busy,
                         trainable_busy_us_20_steps=trainable[name][2],
                         optimizer_params=counts[True],
                         fewer_params=fewer, launches=launches)
        del model, trainer
        torch.cuda.empty_cache()
    return out


def options_trace(torch, kernels, data):
    """(e) fit of LightGCN for 2 epochs with profile_trace_dir: epoch 1
    under torch.profiler, its trace written, naming the SpMM kernel."""
    import shutil

    from foodrec_tpu_torch.engine.trainer import Trainer

    tag = "9 trace"
    shutil.rmtree(TRACE_ROOT, ignore_errors=True)
    cfg = option_config("LightGCN", epochs=2, eval_step=2,
                        profile_trace_dir=TRACE_ROOT)
    model = option_model(torch, cfg, data)
    trainer = Trainer(cfg, model)
    reset_launches(kernels)
    t0 = time.perf_counter()
    trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
    path = os.path.join(TRACE_ROOT, "epoch_1.pt.trace.json")
    if not os.path.isfile(path):
        raise AssertionError(f"{tag}: no trace at {path}")
    with open(path) as f:
        text = f.read()
    n_items = text.count("spmm_csr_items")
    log(f"[{tag}] fit 2 epochs {wall:.3f} s, launches {launches}; trace "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, names spmm_csr_items "
        f"{n_items} times")
    if not n_items:
        raise AssertionError(f"{tag}: the trace does not name the kernel")
    shutil.rmtree(TRACE_ROOT, ignore_errors=True)
    return dict(fit_s=wall, launches=launches, trace_mentions=n_items)


def phase_options(torch, kernels, data, trainable):
    """Phase 9: the training and data options on the Foodcom-scale
    synthetic through the kernel; `data` is phase 4's CIKM_Model FoodData."""
    out = {"health": options_health(torch, kernels)}
    torch.cuda.empty_cache()
    out["learners"] = options_learners(torch, kernels, data)
    out["frozen"] = options_frozen(torch, kernels, data, trainable)
    out["trace"] = options_trace(torch, kernels, data)
    torch.cuda.empty_cache()
    return out


# phase 10: scale-out on the one card. Rank groups are spawned processes
# (foodrec_tpu_torch/parallel/spawn.py) on the cached Foodcom-scale data;
# two or four ranks share the card over gloo (NCCL refuses two ranks on one
# card), one rank runs NCCL through torchrun's environment.
MESH_STEPS = 20        # SGD steps of each mesh comparison
MESH_TIMEOUT = 300     # s a rank group may run before it is ended
MESH_ROOT = os.path.join(ROOT, "build", "mesh")
# the JAX package's tests/test_mesh.py bars: loss parts, then the parameters'
# global relative L2 and max |delta|; and the update's relative L2
# (|theta_mesh - theta_alone| / |theta_alone - theta_0|), which a sharding
# fault moves by O(1) even where the parameters barely move
MESH_PART_RTOL, MESH_REL_L2, MESH_MAX_ABS = 1e-4, 1e-4, 1e-3
MESH_UPDATE_REL = 1e-3
MESH_FLOOR_FACTOR = 10
# A reduced gradient against one process's at the same parameters, at every
# step: a fault detector. A shard dropped, counted twice or scaled wrong
# moves the whole gradient, or its leaves, by 0.1-1 of their size; the
# batch's sums in another order (two halves, each through its own GEMMs)
# move CIKM_Model's by up to 2.0e-4 in relative L2 and a leaf's max |d| by
# 1.1e-4 of its largest entry (its modality path normalizes over two rows;
# measured on an H100 80GB HBM3 at 700 W). The exactness of the semantics
# is the float64 tests' (tests/test_torch_port_mesh.py, 1e-9). A key bias,
# zero in exact arithmetic, is held to its query bias's scale.
MESH_GRAD_L2, MESH_GRAD_LEAF = 1e-2, 1e-2
# The 2-rank trajectories take SGD at this lr. CIKM_Model's trajectory is
# chaotic in float32 even so: its health BCE sums 6,144 terms, so a step
# moves an element a lot and a rounding difference about doubles a step. On
# an H100 80GB HBM3 at 700 W, {data: 2} against one process read loss parts
# 4.95e-3 apart by step 19 at the shipped lr 0.002 and 9.0e-3 at 1e-4,
# while two runs alone one rounding apart read 1.05e-2 at 1e-4 (sgd's
# kernel and `segment` paths part so too, phase 9). So each trajectory is
# also run alone from parameters one rounding away (the floor), and a bar
# that the floor passes holds the mesh to MESH_FLOOR_FACTOR times it.
MESH_LR = 1e-4
# CLUSSL from the k-means centers: its 2,000-row prototype tables (2048-d
# image, 512-d text) are the ones JAX's rule row-shards at model 2
CLUSSL_CENTER = {"use_center_embedding": True}
_MESH_DATA = {}


def mesh_data(name, **extra):
    """(config, FoodData) of `name` through the kernel, weights seed SEED;
    the data loaded once a model per process."""
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData

    cfg = option_config(name, **extra)
    if name not in _MESH_DATA:
        data = FoodData(cfg)
        data.device_data = DeviceData.from_food_data(data)
        _MESH_DATA[name] = data
    return cfg, _MESH_DATA[name]


def model_hops(model):
    return (model.n_layers + model.ui_layers
            if type(model).__name__ == "CIKM_Model"
            else sum(zoo_hops(model).values()))


def mesh_steps(torch, kernels, name, mesh_shape, extra=None, start=False,
               twin=False, perturb=False):
    """MESH_STEPS SGD steps of `name` on its trainer's first batches, under
    mesh_shape (None: this process alone), launches counted (one forward
    and one backward a hop a step asserted): loss parts [steps, parts],
    the whole state on the host (and the one before the steps, with
    `start`), launches, row-sharded tables, s. `perturb` scales every
    parameter by 1 + 2^-23 n (n standard normal, seed SEED) first: a run
    that differs from the plain one by rounding. `twin`: rank 0 holds a
    model without the mesh, loads the mesh's parameters before each step,
    computes that step's gradient on the same global batch with the same
    draws, and the mesh's reduced gradient is held to it within
    MESH_GRAD_L2 and MESH_GRAD_LEAF (the worst of each returned as
    grad_l2 and grad_err)."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, data = mesh_data(name, learner="sgd", mesh_shape=mesh_shape,
                          **(extra or {}))
    model = option_model(torch, cfg, data)
    if perturb:
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0 ** -23 * torch.randn(
                    p.shape, generator=gen).to(p.device))
    trainer = Trainer(cfg, model)
    shadow = None
    if twin and trainer.mesh.rank == 0:
        cfg1, _ = mesh_data(name, learner="sgd", mesh_shape=None,
                            **(extra or {}))
        shadow = Trainer(cfg1, option_model(torch, cfg1, data))
    state0 = trainer._host_snapshot() if start else None
    perm = trainer._epoch_perm()
    trainer.epoch_batch = 0
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    parts, grad_err, grad_l2 = [], 0.0, 0.0
    for step, b in enumerate(trainer._batches(perm, 0, MESH_STEPS)):
        if twin:
            whole = trainer.model.full_state_dict()  # a collective
        if shadow is not None:
            # the twin's launches compare, they are not the mesh's path
            before = spmm_launches(kernels.launches)
            shadow.model.load_state_dict(whole)
            shadow.generator.set_state(trainer.generator.get_state())
            shadow._backward(*b)
            for k, v in before.items():
                kernels.launches[k] = v
        parts.append(trainer.train_steps([b]))
        if shadow is not None:
            want = {n: q.grad for n, q in shadow.model.named_parameters()}
            sq_d = sq_g = 0.0
            for n, p in trainer.model.named_parameters():
                g = want[n]
                scale = want[n.replace("k_b", "q_b")] if n.endswith(
                    "k_b") else g
                if n in trainer.model.row_shards:
                    first = trainer.model.row_shards[n][0]
                    g = g[first:first + p.shape[0]]
                d = (p.grad - g).double()
                sq_d += float((d * d).sum())
                sq_g += float((g.double() ** 2).sum())
                top = float(scale.abs().max())
                rel = float(d.abs().max()) / top if top > 0 else float(
                    d.abs().max())
                if not rel <= MESH_GRAD_LEAF:
                    raise AssertionError(
                        f"{name} {mesh_shape} step {step} gradient {n}: "
                        f"{rel:.3e} of its largest entry")
                grad_err = max(grad_err, rel)
            l2 = (sq_d / sq_g) ** 0.5 if sq_g > 0 else sq_d ** 0.5
            if not l2 <= MESH_GRAD_L2:
                raise AssertionError(f"{name} {mesh_shape} step {step}: the "
                                     f"gradient's relative L2 {l2:.3e}")
            grad_l2 = max(grad_l2, l2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del shadow
    launches = spmm_launches(kernels.launches)
    hops = model_hops(model)
    want = {"spmm_csr": hops * MESH_STEPS, "spmm_csr_bwd": hops * MESH_STEPS}
    if launches != want:
        raise AssertionError(f"{name} {mesh_shape}: launches {launches}, "
                             f"expected {want}")
    return dict(parts=torch.stack(parts).cpu().numpy(),
                state=trainer._host_snapshot(), start=state0,
                launches=launches, sharded=sorted(model.row_shards), s=secs,
                grad_err=grad_err, grad_l2=grad_l2)


def trajectory_gap(torch, got, want):
    """(loss parts' worst relative difference, parameters' relative L2 and
    max |delta|, the update's relative L2, bitwise) of two runs of
    mesh_steps; `want` holds its start, and `got` its own where it started
    elsewhere (the rounding floor's run): the updates are then compared."""
    parts_rel = float(np.max(np.abs(got["parts"] - want["parts"])
                             / np.maximum(np.abs(want["parts"]), 1e-30)))
    keys = sorted(want["state"])
    if sorted(got["state"]) != keys:
        raise AssertionError("the runs' leaves differ")
    diff = torch.cat([(got["state"][k].double() - want["state"][k].double())
                      .ravel() for k in keys])
    ref = torch.cat([want["state"][k].double().ravel() for k in keys])
    rel_l2 = float(diff.norm() / ref.norm())
    max_abs = float(diff.abs().max())
    moved = torch.cat([(want["state"][k].double()
                        - want["start"][k].double()).ravel() for k in keys])
    if got["start"] is not None:
        diff_update = diff - torch.cat([
            (got["start"][k].double() - want["start"][k].double()).ravel()
            for k in keys])
    else:
        diff_update = diff
    update_rel = float(diff_update.norm() / moved.norm())
    bitwise = all(torch.equal(got["state"][k], want["state"][k]) for k in keys)
    return parts_rel, rel_l2, max_abs, update_rel, bitwise, moved


def mesh_compare(torch, tag, got, want, floor=None):
    """The mesh run against the run alone within the JAX package's bars;
    returns the numbers and whether every leaf is bitwise equal. `floor`,
    a run alone from parameters one rounding away, says how far two
    correct float32 runs part on this trajectory: printed beside."""
    parts_rel, rel_l2, max_abs, update_rel, bitwise, moved = trajectory_gap(
        torch, got, want)
    base = None
    if floor is not None:
        base = trajectory_gap(torch, floor, want)[:4]
        log(f"[10 mesh] {tag}: two runs alone one rounding apart part by "
            f"loss parts {base[0]:.3e}, parameters relative L2 "
            f"{base[1]:.3e}, max |delta| {base[2]:.3e}, update {base[3]:.3e}")
    log(f"[10 mesh] {tag}: {MESH_STEPS} SGD steps against one process: "
        f"loss parts worst relative {parts_rel:.3e}, parameters relative L2 "
        f"{rel_l2:.3e}, max |delta| {max_abs:.3e}, update relative L2 "
        f"{update_rel:.3e} (the update's L2 {float(moved.norm()):.3e}), "
        f"bitwise {bitwise}; {got['s']:.3f} s (alone {want['s']:.3f} s)")
    bars = (MESH_PART_RTOL, MESH_REL_L2, MESH_MAX_ABS, MESH_UPDATE_REL)
    gaps = (parts_rel, rel_l2, max_abs, update_rel)
    # a bar that two runs one rounding apart already exceed cannot tell a
    # fault from float32 rounding: there the mesh is held to
    # MESH_FLOOR_FACTOR times that floor instead
    held = [b if base is None or base[i] <= b else MESH_FLOOR_FACTOR * base[i]
            for i, b in enumerate(bars)]
    if held != list(bars):
        log(f"[10 mesh] {tag}: the rounding floor passes the bars "
            f"{bars}: held to {held}")
    if any(g > h for g, h in zip(gaps, held)):
        raise AssertionError(f"{tag}: the runs part by {gaps}, bars {held}")
    return dict(parts_rel=parts_rel, rel_l2=rel_l2, max_abs=max_abs,
                update_rel=update_rel, bitwise=bitwise, s=got["s"],
                alone_s=want["s"], rounding_floor=base,
                grad_err=got.get("grad_err"), grad_l2=got.get("grad_l2"))


def rank_setup(torch):
    """A rank's matmul settings, as phase 1 sets the parent's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_rank_runner(rank, config_dir, workdir):
    """(a), one NCCL rank: runner.main for CIKM_Model, one epoch, with
    mesh_shape {data: 1} from a dataset yaml; its best checkpoint reloaded
    into a model with no mesh (equal test metrics); MESH_STEPS SGD steps
    under the mesh and alone."""
    import torch

    rank_setup(torch)
    from foodrec_tpu_torch import config as config_mod
    from foodrec_tpu_torch import runner
    from foodrec_tpu_torch.engine import quick_start as qs
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.ops import _kernels

    shipped = config_mod._CONFIG_DIR
    config_mod._CONFIG_DIR = config_dir
    os.chdir(workdir)
    trainers, epoch = [], {}
    get_trainer = qs.get_trainer

    def recording_get_trainer():
        def make(*args, **kwargs):
            trainer = get_trainer()(*args, **kwargs)
            train_epoch = trainer.train_epoch

            def counted_epoch():
                before = spmm_launches(_kernels.launches)
                t0 = time.perf_counter()
                parts = train_epoch()
                torch.cuda.synchronize()
                epoch["s"] = time.perf_counter() - t0
                epoch["launches"] = {k: v - before[k] for k, v in
                                     spmm_launches(_kernels.launches).items()}
                return parts

            trainer.train_epoch = counted_epoch
            trainers.append(trainer)
            return trainer

        return make

    qs.get_trainer = recording_get_trainer
    reset_launches(_kernels)
    t0 = time.perf_counter()
    try:
        hyper, valid, test = runner.main([
            "-m", "CIKM_Model", "-d", DATASET, "--data_path", DATA_ROOT + "/",
            "--epochs", "1", "--neg_sample_num",
            str(FOODCOM_SCALE["neg_num"])])
    finally:
        qs.get_trainer = get_trainer
        config_mod._CONFIG_DIR = shipped
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = spmm_launches(_kernels.launches)
    (trainer,) = trainers
    mesh = trainer.mesh
    mesh_info = dict(shape=mesh.shape, backend=mesh.backend,
                     device=str(mesh.device))
    n_evals = 2  # valid after the epoch, then the test
    hops = trainer.model.n_layers + trainer.model.ui_layers
    want_epoch = {"spmm_csr": hops * trainer.n_batches,
                  "spmm_csr_bwd": hops * trainer.n_batches}
    if epoch["launches"] != want_epoch:
        raise AssertionError(f"(a) epoch launches {epoch['launches']}, "
                             f"expected {want_epoch}")
    ckpts = os.listdir("ckp")
    logs = os.listdir("log")
    if len(ckpts) != 1 or len(logs) != 1:
        raise AssertionError(f"(a) checkpoints {ckpts}, logs {logs}")
    del trainer, trainers
    torch.cuda.empty_cache()

    cfg, data = mesh_data("CIKM_Model")
    fresh = option_model(torch, cfg, data)
    fresh.load_state_dict(Trainer.load_checkpoint(os.path.join("ckp",
                                                              ckpts[0])))
    reloaded = Trainer(cfg, fresh).evaluate(data.device_data.eval_test,
                                            is_test=True)
    if reloaded != test:
        raise AssertionError(f"(a) reloaded test metrics {reloaded} != the "
                             f"run's {test}")
    del fresh
    torch.cuda.empty_cache()
    steps = mesh_steps(torch, _kernels, "CIKM_Model", {"data": 1})
    alone = mesh_steps(torch, _kernels, "CIKM_Model", None, start=True)
    return dict(hyper=hyper, test=test, cli_s=cli_s, epoch=epoch,
                launches=launches, n_evals=n_evals, mesh=mesh_info,
                checkpoint=ckpts[0], steps=steps, alone=alone)


def mesh_rank_steps(rank, cases):
    """(b) and CLUSSL of (c): MESH_STEPS SGD steps of each (name, mesh,
    extra) on this rank; every rank's launches, rank 0's parts and state."""
    import torch

    from foodrec_tpu_torch.ops import _kernels

    out = {}
    rank_setup(torch)
    for name, shape, extra in cases:
        r = mesh_steps(torch, _kernels, name, shape, extra, twin=True)
        out[name] = r if rank == 0 else {"launches": r["launches"]}
        torch.cuda.empty_cache()
    return out


def full_sort_ids(torch, trainer):
    """(top-k ids [U, k] of every user, (score, metrics)) of the trainer's
    full-sort test eval; the ids through distributed_full_sort_topk under a
    `model` axis, as `_valid_full_sort` takes them."""
    import functools

    from foodrec_tpu_torch.engine.topk_evaluator import (
        TopKEvaluator,
        distributed_full_sort_topk,
        full_sort_topk,
    )

    model = trainer.model
    k = max(TopKEvaluator(trainer.config).topk)
    sweep = full_sort_topk
    if trainer.mesh is not None:
        sweep = functools.partial(distributed_full_sort_topk, trainer.mesh)
    with torch.no_grad():
        ids = sweep(functools.partial(model.score_items, model.eval_cache()),
                    list(range(model.dataset.num_users)),
                    model.dataset.num_items, k,
                    user_batch=min(trainer.eval_batch_size, 64),
                    device=model.device)
    return ids.numpy(), trainer._valid_full_sort(is_test=True)


def gloo_on_cuda(torch):
    """Which collectives gloo runs on CUDA tensors, asked of the group
    directly (parallel/collectives.py counts on all three): {op: "yes"
    with the right sum or gather, or the error it raised}."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.full((4,), float(r + 1), device="cuda")
    want = {"all_reduce": torch.full((4,), n * (n + 1) / 2, device="cuda"),
            "broadcast": torch.full((4,), 1.0, device="cuda"),
            "all_gather": torch.cat([torch.full((4,), float(i + 1),
                                                device="cuda")
                                     for i in range(n)])}

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    calls = {"all_reduce": lambda: dist.all_reduce(y := x.clone()) or y,
             "broadcast": lambda: dist.broadcast(y := x.clone(), 0) or y,
             "all_gather": all_gather}
    out = {}
    for op, call in calls.items():
        try:
            got = call()
            torch.cuda.synchronize()
            out[op] = "yes" if torch.equal(got, want[op]) else "wrong result"
        except RuntimeError as e:
            out[op] = str(e).splitlines()[0][:160]
    return out


def mesh_rank_full_sort(rank, mesh_shape):
    """(c): CIKM_Model's full-sort test eval over a `model` axis: every
    rank's launches, rank 0's ids, metrics and s; first, which collectives
    gloo runs on CUDA tensors."""
    import torch

    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.ops import _kernels

    rank_setup(torch)
    gloo = gloo_on_cuda(torch)
    cfg, data = mesh_data("CIKM_Model", mesh_shape=mesh_shape,
                          full_sort=True, eval_by_user=False,
                          save_recommended_topk=False)
    trainer = Trainer(cfg, option_model(torch, cfg, data))
    torch.cuda.synchronize()
    reset_launches(_kernels)
    t0 = time.perf_counter()
    ids, (score, metrics) = full_sort_ids(torch, trainer)
    torch.cuda.synchronize()
    out = dict(launches=spmm_launches(_kernels.launches),
               s=time.perf_counter() - t0)
    if rank == 0:
        out.update(ids=ids, score=score, metrics=metrics, gloo=gloo)
    return out


def rank_launches(tag, ranks, key=None):
    """The launches of a group's ranks summed; every rank launched."""
    per = [r[key]["launches"] if key else r["launches"] for r in ranks]
    if any(p["spmm_csr"] == 0 for p in per):
        raise AssertionError(f"{tag}: a rank launched no kernel: {per}")
    return {k: sum(p[k] for p in per) for k in per[0]}


def phase_mesh(torch, kernels):
    """Phase 10: mesh_shape through torch.distributed on the one card:
    (a) one NCCL rank started as torchrun starts it, the user's path;
    (b) two ranks over gloo, {data: 2}: CIKM_Model, BM3 and SCHGN, 20 SGD
    steps each against one process; (c) two ranks over gloo, {model: 2}:
    CLUSSL with its prototype tables row-sharded, 20 SGD steps, and
    CIKM_Model's full-sort test eval through distributed_full_sort_topk
    (equal ids and metrics); (d) dryrun_multichip(4), {data: 2, model: 2},
    four ranks over gloo. Every rank group has a deadline."""
    import shutil
    import socket

    from foodrec_tpu_torch import config as config_mod
    from foodrec_tpu_torch.multichip import dryrun_multichip
    from foodrec_tpu_torch.parallel.spawn import run_ranks

    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    config_dir = os.path.join(MESH_ROOT, "configs")
    shutil.copytree(config_mod._CONFIG_DIR, config_dir)
    os.makedirs(os.path.join(config_dir, "dataset"), exist_ok=True)
    with open(os.path.join(config_dir, "dataset", f"{DATASET}.yaml"),
              "w") as f:
        f.write("mesh_shape: {data: 1}\n")
    workdir = os.path.join(MESH_ROOT, "driver")
    os.makedirs(workdir)
    out, by_path = {}, {}
    t_phase = time.perf_counter()

    # (a) one rank, NCCL initialized by make_mesh from torchrun's variables
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    (a,) = run_ranks(mesh_rank_runner, 1, args=(config_dir, workdir),
                     backend=None, timeout=MESH_TIMEOUT,
                     env={"MASTER_ADDR": "localhost",
                          "MASTER_PORT": str(port)})
    a_s = time.perf_counter() - t0
    log(f"[10 mesh] (a) runner.main, CIKM_Model, 1 epoch, mesh {a['mesh']}: "
        f"wall {a['cli_s']:.3f} s (epoch {a['epoch']['s']:.3f} s), best "
        f"{a['hyper']}, checkpoint {a['checkpoint']}; epoch launches "
        f"{a['epoch']['launches']}, run {a['launches']}; reloaded into a "
        f"model with no mesh: equal test metrics {json.dumps(a['test'])}; "
        f"group {a_s:.1f} s")
    out["a"] = dict(cli_s=a["cli_s"], epoch_s=a["epoch"]["s"],
                    epoch_launches=a["epoch"]["launches"], mesh=a["mesh"],
                    group_s=a_s, test=a["test"],
                    steps=mesh_compare(torch, "(a) CIKM_Model {data: 1}, NCCL",
                                       a["steps"], a["alone"]))
    by_path["mesh (a) runner {data: 1}"] = a["launches"]
    by_path["mesh (a) 20 steps {data: 1}"] = a["steps"]["launches"]

    # (b) {data: 2} and (c) {model: 2}, two ranks sharing the card over gloo
    lr = {"learning_rate": MESH_LR}
    cases = {"b": [("CIKM_Model", {"data": 2}, lr),
                   ("BM3", {"data": 2}, lr),
                   ("SCHGN", {"data": 2}, lr)],
             "c": [("PRICAI_ModelX", {"model": 2}, {**lr, **CLUSSL_CENTER})]}
    for part, group in cases.items():
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank_steps, 2, args=(group,), backend="gloo",
                          timeout=MESH_TIMEOUT)
        g_s = time.perf_counter() - t0
        for name, shape, extra in group:
            got = ranks[0][name]
            if shape.get("model", 1) > 1 and not got["sharded"]:
                raise AssertionError(f"({part}) {name}: no table sharded")
            alone = mesh_steps(torch, kernels, name, None, extra, start=True)
            floor = mesh_steps(torch, kernels, name, None, extra, start=True,
                               perturb=True)
            tag = f"({part}) {name} {shape}, gloo, row-sharded {got['sharded']}"
            log(f"[10 mesh] {tag}: the mesh's reduced gradient against one "
                f"process's at the same parameters at each of {MESH_STEPS} "
                f"steps: relative L2 {got['grad_l2']:.3e} at worst (bar "
                f"{MESH_GRAD_L2:.0e}), a leaf's max|d| {got['grad_err']:.3e} "
                f"of its largest entry at worst (bar {MESH_GRAD_LEAF:.0e})")
            out[f"{part} {name}"] = dict(
                mesh_compare(torch, tag, got, alone, floor),
                sharded=got["sharded"], group_s=g_s)
            by_path[f"mesh ({part}) {name} 20 steps {shape}"] = rank_launches(
                tag, ranks, name)
            torch.cuda.empty_cache()
        log(f"[10 mesh] ({part}) group of 2 ranks: {g_s:.1f} s")

    # (c) the full-sort test eval over {model: 2}
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank_full_sort, 2, args=({"model": 2},),
                      backend="gloo", timeout=MESH_TIMEOUT)
    g_s = time.perf_counter() - t0
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, data = mesh_data("CIKM_Model", full_sort=True, eval_by_user=False,
                          save_recommended_topk=False)
    trainer = Trainer(cfg, option_model(torch, cfg, data))
    t0 = time.perf_counter()
    ids, (score, metrics) = full_sort_ids(torch, trainer)
    alone_s = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"[10 mesh] gloo on CUDA tensors, asked of a 2-rank group: "
        f"{json.dumps(r0['gloo'])}")
    out["gloo_on_cuda"] = r0["gloo"]
    if set(r0["gloo"].values()) != {"yes"}:
        raise AssertionError(f"gloo on CUDA tensors: {r0['gloo']}")
    equal = float((r0["ids"] == ids).mean())
    log(f"[10 mesh] (c) full-sort test over {{model: 2}}: {ids.shape[0]} "
        f"users x {data.num_items} items, k={ids.shape[1]}, "
        f"{r0['s']:.3f} s (alone {alone_s:.3f} s); ids equal to "
        f"full_sort_topk's in {equal:.6f} of slots; metrics equal "
        f"{r0['metrics'] == metrics}; group {g_s:.1f} s")
    if equal != 1.0 or r0["metrics"] != metrics or r0["score"] != score:
        raise AssertionError("(c) distributed full-sort differs from "
                             "full_sort_topk")
    out["c full_sort"] = dict(s=r0["s"], alone_s=alone_s, group_s=g_s,
                              metrics=metrics)
    by_path["mesh (c) full_sort test {model: 2}"] = rank_launches(
        "(c) full_sort", ranks)
    del trainer
    torch.cuda.empty_cache()

    # (d) the dry run on four ranks sharing the card
    t0 = time.perf_counter()
    d = dryrun_multichip(4, device="cuda", timeout=MESH_TIMEOUT)
    d_s = time.perf_counter() - t0
    if d["backend"] != "gloo":
        raise AssertionError(f"(d) backend {d['backend']}")
    per = d.pop("launches")
    if any(p["spmm_csr"] == 0 for p in per):
        raise AssertionError(f"(d) a rank launched no kernel: {per}")
    by_path["mesh (d) dryrun_multichip(4)"] = {
        k: sum(p[k] for p in per) for k in per[0]}
    out["d"] = dict(d, group_s=d_s)
    log(f"[10 mesh] (d) dryrun_multichip(4) over gloo: {d_s:.1f} s")
    phase_s = time.perf_counter() - t_phase
    log(f"[10 mesh] launches by path (summed over each group's ranks): "
        f"{json.dumps(by_path)}; phase {phase_s:.1f} s")
    out["phase_s"] = phase_s
    return out, by_path


# phase 11: the offline pipeline on the card. A raw Food.com tree at the size
# of the Kaggle release ("Food.com Recipes and Interactions", Shuyang Li:
# 1,132,367 interactions by 226,570 users on 231,637 recipes, 178,265 of
# them preprocessed with ingredient ids, ~8k ingredients), generated from a
# seed, goes through the port's preprocess CLI (the k-means on the card),
# then CIKM_Model and CLUSSL train on what it wrote, through the kernel.
PIPELINE_ROOT = os.path.join(ROOT, "build", "pipeline")
PIPELINE_DATASET = "FoodcomRaw"
FOODCOM_RAW = dict(
    n_rows=1_132_367, n_users=226_570, n_recipes=231_637, n_pp=178_265,
    n_ingredients=8_023, max_recipe_id=537_716, first_day="2000-01-25",
    last_day="2018-12-20",
    # Zipf (exponent, rank offset) of user activity and recipe popularity
    # beyond each user's and recipe's first interaction, tuned so that the
    # 5-core and the temporal split land near Foodcom's processed footprint
    user_zipf=(1.15, 10), item_zipf=(0.75, 100), seed=2024)
FOODCOM_FOOTPRINT = (7596, 29943)   # users x items, BASELINE.md:18
PIPELINE_CLUSTERS = 2000            # the CLI's default, CLUSSL's shipped n
FOOTPRINT_TOL = 0.25
NEG_NUM = 500                       # the CLI's --n-neg default
PIPELINE_STEPS = 20                 # CLUSSL Adam steps on the output
EDGE_CHECK_ITEMS = 1000
EXTRACT_CHECK_ROWS = 64
EXTRACT_REL_TOL = 1e-4
N_IMAGES = 256
# the text encoder at T5-small's width (random weights, seed SEED)
T5_SMALL = dict(layers=6, d_model=512, heads=8, d_ff=2048, max_len=64)
# words of the generated names; none holds a keyword of
# preprocess.INGRE_KEYWORD_SETS, which are put in on purpose
INGREDIENT_NOUNS = (
    "salt", "sugar", "flour", "butter", "egg", "onion", "garlic", "milk",
    "oil", "tomato", "cheese", "chicken", "beef", "rice", "bean", "lemon",
    "carrot", "potato", "cream", "vinegar", "honey", "pasta", "spinach",
    "mushroom", "celery", "ginger", "cinnamon", "basil", "parsley", "thyme",
    "pork", "shrimp", "salmon", "tofu", "corn", "pea", "apple", "banana",
    "yogurt", "walnut", "almond", "oat", "broth", "lime", "cabbage", "squash",
    "zucchini", "peanut", "coconut", "vanilla")
INGREDIENT_MODS = (
    "", "fresh", "ground", "chopped", "low-fat", "frozen", "canned",
    "smoked", "sweet", "hot", "baby", "whole", "light", "wild", "unsalted",
    "organic", "grated", "toasted", "cooked", "plain")
TITLE_WORDS = (
    "easy", "best", "quick", "spicy", "creamy", "baked", "grilled",
    "classic", "homemade", "healthy", "cheesy", "crispy", "slow cooker",
    "one pot", "summer", "winter", "holiday", "family", "weeknight",
    "casserole", "soup", "salad", "stew", "pie", "cake", "bread", "tacos",
    "curry", "muffins", "cookies", "chili", "skillet", "bake", "bowl",
    "sandwich", "wraps", "noodles", "pancakes", "dip", "sauce")
# foodcom's nutrition list: calories, then %DV of fat, sugar, sodium,
# protein, saturated fat and carbohydrates; lognormal medians and spreads
NUTRITION_MEDIAN = np.array([350.0, 25.0, 30.0, 20.0, 25.0, 30.0, 10.0])
NUTRITION_SIGMA = np.array([0.7, 0.9, 1.1, 1.0, 0.9, 1.0, 0.8])


def zipf_draws(rng, n, size, exponent, offset):
    """`size` draws over n categories, P(rank r) ∝ (r + offset)^-exponent,
    the ranks a random permutation of the categories."""
    p = 1.0 / (np.arange(n) + offset) ** exponent
    return rng.permutation(n)[rng.choice(n, size, p=p / p.sum())]


def foodcom_raw_tree(raw_dir, seed=FOODCOM_RAW["seed"]):
    """Write a raw Food.com tree of FOODCOM_RAW's size under raw_dir: the
    columns preprocess_cli's loader reads (RAW_interactions.csv: user_id,
    recipe_id, date; RAW_recipes.csv: name, id, nutrition; PP_recipes.csv:
    id, ingredient_ids; ingr_map.pkl: id, processed). Zipf user activity and
    recipe popularity, repeated (user, recipe) pairs dropped, day-resolution
    dates over 2000-2018 (heavy ties), each name keyword of the ii graph in
    ~3% of the ingredient names. Returns the counts, the ingredient names
    by id and the titles by recipe id (for the text extractor)."""
    import csv
    import datetime

    import pandas as pd

    c = FOODCOM_RAW
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    recipe_ids = np.sort(rng.choice(c["max_recipe_id"] - 37, c["n_recipes"],
                                    replace=False) + 38)
    user_ids = np.unique(rng.integers(1, 2 ** 31 - 1, 2 * c["n_users"]))
    user_ids = rng.permutation(user_ids)[:c["n_users"]]

    # every user and recipe once (the release has no empty one), then Zipf
    n0 = max(c["n_users"], c["n_recipes"])
    m = int(c["n_rows"] * 1.3)
    u = np.concatenate([rng.permutation(np.concatenate([
        np.arange(c["n_users"]),
        rng.integers(0, c["n_users"], n0 - c["n_users"])])),
        zipf_draws(rng, c["n_users"], m, *c["user_zipf"])])
    i = np.concatenate([rng.permutation(np.concatenate([
        np.arange(c["n_recipes"]),
        rng.integers(0, c["n_recipes"], n0 - c["n_recipes"])])),
        zipf_draws(rng, c["n_recipes"], m, *c["item_zipf"])])
    _, first = np.unique(u.astype(np.int64) * c["n_recipes"] + i,
                         return_index=True)
    first = np.sort(first)[:c["n_rows"]]
    u, i = u[first], i[first]
    d0 = datetime.date.fromisoformat(c["first_day"])
    n_days = (datetime.date.fromisoformat(c["last_day"]) - d0).days + 1
    days = np.arange(n_days)
    w = 0.15 + np.exp(-0.5 * ((days - 0.45 * n_days) / (0.15 * n_days)) ** 2)
    day_str = [(d0 + datetime.timedelta(days=int(k))).isoformat()
               for k in days]
    day = rng.choice(n_days, len(u), p=w / w.sum())
    with open(os.path.join(raw_dir, "RAW_interactions.csv"), "w",
              newline="") as f:
        f.write("user_id,recipe_id,date\n")
        f.write("".join(f"{a},{b},{day_str[k]}\n" for a, b, k in zip(
            user_ids[u].tolist(), recipe_ids[i].tolist(), day.tolist())))

    mods = rng.choice(INGREDIENT_MODS, c["n_ingredients"])
    nouns = rng.choice(INGREDIENT_NOUNS, c["n_ingredients"])
    names = [f"{a} {b} {k}".strip() for k, (a, b) in enumerate(
        zip(mods.tolist(), nouns.tolist()))]
    from foodrec_tpu_torch.data.preprocess import INGRE_KEYWORD_SETS

    for kw in (k for s in INGRE_KEYWORD_SETS for k in s):
        for j in np.flatnonzero(rng.random(c["n_ingredients"]) < 0.03):
            names[j] = f"{kw} {names[j]}"
    pd.DataFrame({"id": np.arange(c["n_ingredients"]),
                  "processed": names}).to_pickle(
        os.path.join(raw_dir, "ingr_map.pkl"))

    pp_ids = np.sort(rng.choice(recipe_ids, c["n_pp"], replace=False))
    n_ing = np.minimum(1 + rng.poisson(8, c["n_pp"]), 40)
    ing = zipf_draws(rng, c["n_ingredients"], int(n_ing.sum()), 0.9, 5)
    starts = np.concatenate([[0], np.cumsum(n_ing)[:-1]]).tolist()
    ing = ing.tolist()
    with open(os.path.join(raw_dir, "PP_recipes.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["id", "ingredient_ids"])
        out.writerows(
            (r, "[" + ", ".join(map(str, dict.fromkeys(ing[s:s + k]))) + "]")
            for r, s, k in zip(pp_ids.tolist(), starts, n_ing.tolist()))

    nutri = np.round(NUTRITION_MEDIAN * np.exp(
        NUTRITION_SIGMA * rng.standard_normal((c["n_recipes"], 7))), 1)
    words = rng.choice(TITLE_WORDS, (c["n_recipes"], 4))
    n_words = rng.integers(2, 5, c["n_recipes"])
    titles = {}
    with open(os.path.join(raw_dir, "RAW_recipes.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["name", "id", "nutrition"])
        for r, ws, k, nu in zip(recipe_ids.tolist(), words.tolist(),
                                n_words.tolist(), nutri.tolist()):
            title = " ".join(ws[:k]) + (f", \"no. {r % 97}\"" if r % 5 == 0
                                        else "")
            titles[r] = title
            out.writerow([title, r, "[" + ", ".join(f"{v:.1f}" for v in nu)
                          + "]"])
    counts = dict(interactions=len(u), users=len(np.unique(u)),
                  recipes=c["n_recipes"], recipes_in_interactions=len(
                      np.unique(i)), pp_recipes=c["n_pp"],
                  ingredients=c["n_ingredients"], days=n_days)
    return counts, dict(enumerate(names)), titles


class CharTokenizer:
    """The tokenizer call of t5_text_features (texts -> input_ids and
    attention_mask, padded to the batch's longest, truncated to max_len) on
    UTF-8 bytes: id = byte + 1, 0 pads."""

    def __init__(self, torch, max_len):
        self.torch, self.max_len = torch, max_len

    def __call__(self, texts, return_tensors=None, padding=True,
                 truncation=True):
        seqs = [[b + 1 for b in t.encode("utf-8")][:self.max_len] or [1]
                for t in texts]
        width = max(len(s) for s in seqs)
        ids = self.torch.zeros((len(seqs), width), dtype=self.torch.long)
        mask = self.torch.zeros_like(ids)
        for r, s in enumerate(seqs):
            ids[r, :len(s)] = self.torch.tensor(s)
            mask[r, :len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def t5_small_encoder(torch, seed=SEED):
    """A pre-LN transformer encoder at T5-small's width (T5_SMALL), random
    weights from `seed`, returning `.last_hidden_state` as T5EncoderModel
    does; byte ids in, learned positions."""
    from types import SimpleNamespace

    cfg = T5_SMALL
    nn = torch.nn

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(257, cfg["d_model"])
            self.pos = nn.Embedding(cfg["max_len"], cfg["d_model"])
            layer = nn.TransformerEncoderLayer(
                cfg["d_model"], cfg["heads"], cfg["d_ff"], dropout=0.0,
                batch_first=True, norm_first=True)
            self.layers = nn.TransformerEncoder(
                layer, cfg["layers"], enable_nested_tensor=False)
            self.norm = nn.LayerNorm(cfg["d_model"])

        def forward(self, input_ids=None, attention_mask=None):
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)
            h = self.embed(input_ids) + self.pos(pos)[None]
            h = self.layers(h, src_key_padding_mask=attention_mask == 0)
            return SimpleNamespace(last_hidden_state=self.norm(h))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Encoder().eval()


def conv_backbone(torch, seed=SEED):
    """A conv stack of output width 2048 (ResNet-50's, fc = Identity),
    random weights from `seed`."""
    nn = torch.nn
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
            nn.Conv2d(64, 256, 3, 2, 1), nn.ReLU(),
            nn.Conv2d(256, 1024, 3, 2, 1), nn.ReLU(),
            nn.Conv2d(1024, 2048, 3, 2, 1), nn.AdaptiveAvgPool2d(1),
            nn.Flatten()).eval()


def rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def pipeline_extractors(torch, texts, image_dir):
    """(c) t5_text_features over `texts` with the T5-small-width encoder
    and resnet50_image_features over N_IMAGES generated JPEGs with the conv
    backbone, on the card; EXTRACT_CHECK_ROWS rows of each against the same
    call on the CPU."""
    from PIL import Image

    from foodrec_tpu_torch.data import preprocess as pp

    tag = "11 extract"
    tok = CharTokenizer(torch, T5_SMALL["max_len"])
    enc = t5_small_encoder(torch)
    t0 = time.perf_counter()
    feats = pp.t5_text_features(texts, tokenizer=tok, encoder=enc)
    text_s = time.perf_counter() - t0
    ref = pp.t5_text_features(texts[:EXTRACT_CHECK_ROWS], tokenizer=tok,
                              encoder=enc, device="cpu")
    text_err = rel_err(feats[:EXTRACT_CHECK_ROWS], ref)
    log(f"[{tag}] text: {len(texts)} texts -> {feats.shape} "
        f"{feats.dtype} in {text_s:.3f} s ({len(texts) / text_s:.0f} "
        f"texts/s); {EXTRACT_CHECK_ROWS} rows against the CPU: max rel "
        f"{text_err:.3e}")
    if feats.shape != (len(texts), T5_SMALL["d_model"]) or \
            not np.isfinite(feats).all() or not text_err <= EXTRACT_REL_TOL:
        raise AssertionError(f"{tag}: text features {feats.shape}, "
                             f"rel err {text_err}")

    rng = np.random.default_rng(SEED)
    os.makedirs(image_dir, exist_ok=True)
    paths = []
    for k in range(N_IMAGES):
        h, w = rng.integers(160, 320, 2)
        ramp = np.linspace(0, 1, int(w))[None, :, None] * rng.random(3)
        img = (255 * np.clip(ramp + 0.3 * rng.random((int(h), int(w), 3)),
                             0, 1)).astype(np.uint8)
        paths.append(os.path.join(image_dir, f"{k}.jpg"))
        Image.fromarray(img).save(paths[-1])
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def transform(img):
        x = np.asarray(img.resize((224, 224)), np.float32) / 255.0
        return torch.from_numpy((x - mean) / std).permute(2, 0, 1)

    backbone = conv_backbone(torch)
    t0 = time.perf_counter()
    img_feats = pp.resnet50_image_features(paths, backbone=backbone,
                                           transform=transform)
    image_s = time.perf_counter() - t0
    n_check = EXTRACT_CHECK_ROWS // 4
    ref = pp.resnet50_image_features(paths[:n_check], backbone=backbone,
                                     transform=transform, device="cpu")
    image_err = rel_err(img_feats[:n_check], ref)
    log(f"[{tag}] image: {N_IMAGES} JPEGs -> {img_feats.shape} in "
        f"{image_s:.3f} s ({N_IMAGES / image_s:.0f} images/s); {n_check} "
        f"rows against the CPU: max rel {image_err:.3e}")
    if img_feats.shape != (N_IMAGES, 2048) or \
            not np.isfinite(img_feats).all() or \
            not image_err <= EXTRACT_REL_TOL:
        raise AssertionError(f"{tag}: image features {img_feats.shape}, "
                             f"rel err {image_err}")
    return dict(text_s=text_s, n_texts=len(texts), text_rel_err=text_err,
                image_s=image_s, n_images=N_IMAGES, image_rel_err=image_err)


def pipeline_outputs(torch, out):
    """(b)'s checks: every contract file, FoodData on it, each k-means
    below its own init's inertia, and the first edge of EDGE_CHECK_ITEMS
    items the nearest centre in float64."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths

    tag = "11 pipeline"
    base = out["base"]
    want = ["data.train.rating", "data.valid.rating", "data.test.rating",
            "data.valid.negative", "data.test.negative",
            "data_image_features_float.npy", "data_text_features_t5.npy",
            "data_ingre_code_file.npy", "data_id_ingre_num_file",
            "ri_graph.txt", "mapping_dict.pkl", "inter_coo_matrix.pkl",
            *(f"graph_edge/{n}" for n in (
                "ri_graph.txt", "ii_graph.txt", "ur_graph.txt",
                "rc_graph.txt", "recipe_cal_level_dict.pkl",
                "recipe_cal_level_map.pkl", "rh_graph.txt",
                "recipe_health_level_dict.pkl",
                "recipe_health_level_multi_hot_dict.pkl",
                "rr_health_graph.txt", "health_sample_dict.pkl")),
            *(f"{d}/{m}_center.npy" for d in ("cluster", "mm_cluster")
              for m in ("image", "text")),
            *(f"cluster/{m}_cluster_edge.txt" for m in ("image", "text"))]
    sizes = {f: os.path.getsize(os.path.join(base, f))
             if os.path.isfile(os.path.join(base, f)) else 0 for f in want}
    if not all(sizes.values()):
        raise AssertionError(f"{tag}: missing or empty: "
                             f"{[f for f, s in sizes.items() if not s]}")
    cfg = Config("CIKM_Model", PIPELINE_DATASET, {
        "data_path": PIPELINE_ROOT + "/", "neg_sample_num": NEG_NUM,
        "load_IngreIngre_graph": True, "load_UserRecipe_graph": True,
        "use_cal_level": True, "load_RecipeCalories_graph": True,
        "load_RecipeHealth_graph": True, "health_neg_sample": True,
        "load_TextCluster_graph": True, "load_ImageCluster_graph": True})
    derive_data_paths(cfg, PIPELINE_DATASET)
    t0 = time.perf_counter()
    data = FoodData(cfg)
    load_s = time.perf_counter() - t0
    n_users, n_items = out["n_users"], out["n_items"]
    shapes = dict(users=data.num_users, items=data.num_items,
                  ingredients=data.num_ingredients, train=data.n_train,
                  valid=data.n_valid, test=data.n_test,
                  image=list(data.embImage.shape),
                  text=list(data.embText.shape),
                  ii_edges=len(data.iIngre_triples),
                  ur_edges=len(data.uRecipe_triples),
                  calorie_levels=data.num_calories_level,
                  health_levels=data.num_health_level)
    log(f"[{tag}] contract files {len(want)} present, "
        f"{sum(sizes.values()) / 2 ** 20:.1f} MiB; FoodData in "
        f"{load_s:.1f} s: {json.dumps(shapes)}")
    if (data.num_users, data.num_items) != (n_users, n_items) or \
            data.embImage.shape != (n_items, 2048) or \
            data.embText.shape != (n_items, 512):
        raise AssertionError(f"{tag}: FoodData {shapes} against "
                             f"{n_users} x {n_items}")
    far = [abs(n / f - 1) for n, f in zip((n_users, n_items),
                                          FOODCOM_FOOTPRINT)]
    if max(far) > FOOTPRINT_TOL:
        raise AssertionError(f"{tag}: {n_users} x {n_items} is off "
                             f"Foodcom's {FOODCOM_FOOTPRINT} by {far}")

    kmeans = {}
    rng = np.random.default_rng(SEED)
    for m in ("image", "text"):
        km = out["kmeans"][m]
        x = np.load(os.path.join(base, f"data_{m}_features_"
                                 + ("float" if m == "image" else "t5")
                                 + ".npy"))
        centers = np.load(os.path.join(base, "cluster", f"{m}_center.npy"))
        edges = np.loadtxt(os.path.join(base, "cluster",
                                        f"{m}_cluster_edge.txt"),
                           dtype=np.int64)
        idx = np.sort(rng.choice(n_items, EDGE_CHECK_ITEMS, replace=False))
        xs = torch.as_tensor(x[idx], dtype=torch.float64, device="cuda")
        cs = torch.as_tensor(centers, dtype=torch.float64, device="cuda")
        d = torch.cdist(xs, cs).square().cpu().numpy()
        first = edges[idx * 6, 1]
        nearest = d.min(1)
        gap = d[np.arange(len(idx)), first] - nearest
        ties = int((first != d.argmin(1)).sum())
        # a float32 distance on the card may order two centres whose
        # float64 distances differ by less than its rounding; a centre may
        # sit on an item (distance 0), where only a gap of 0 passes
        worst = float(np.where(gap == 0, 0.0, gap / np.maximum(
            nearest, np.finfo(np.float64).tiny)).max())
        kmeans[m] = dict(inertia=km.inertia, init_inertia=km.init_inertia,
                         n_steps=km.n_steps, centers=list(centers.shape),
                         centers_dtype=str(centers.dtype),
                         edges=len(edges), first_edge_not_nearest=ties,
                         worst_rel_gap=worst)
        log(f"[{tag}] k-means {m}: {centers.shape} {centers.dtype}, "
            f"{km.n_steps} steps, inertia {km.inertia:.6e} < its k-means++ "
            f"init's {km.init_inertia:.6e}; {len(edges)} edges; first edge "
            f"of {EDGE_CHECK_ITEMS} items against the float64 nearest "
            f"centre: {ties} differ, worst relative distance gap {worst:.3e}")
        if not km.inertia < km.init_inertia:
            raise AssertionError(f"{tag}: {m} inertia {km.inertia} >= init "
                                 f"{km.init_inertia}")
        if centers.dtype != np.float32 or \
                centers.shape != (PIPELINE_CLUSTERS, x.shape[1]) \
                or edges.shape != (6 * n_items, 2) or not worst <= 1e-5:
            raise AssertionError(f"{tag}: {m} centers {centers.shape} "
                                 f"{centers.dtype}, edges {edges.shape}, "
                                 f"worst gap {worst}")
    return shapes, kmeans


def graph_errors(graphs):
    """{"max_abs_err", "grad_max_abs_err"} of zoo_graphs' checks."""
    return dict(max_abs_err=max(g["err"] for g in graphs.values()),
                grad_max_abs_err=max(g["grad_err"] for g in graphs.values()))


def pipeline_clussl(torch, kernels, spmm):
    """(d) PIPELINE_STEPS Adam steps of PRICAI_ModelX (CLUSSL) with its
    shipped 2,000 clusters and the centres as prototypes, on the card's
    cluster/ and mm_cluster/ files, through the kernel, launches counted.
    Before the steps, the kernel is held against plain on each of its
    graphs (zoo_graphs)."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.trainer import Trainer

    tag = "11 clussl"
    cfg = Config("PRICAI_ModelX", PIPELINE_DATASET, {
        "data_path": PIPELINE_ROOT + "/", "seed": SEED,
        "neg_sample_num": NEG_NUM, "spmm_impl": "kernel",
        "n_cluster": PIPELINE_CLUSTERS, "use_center_embedding": True})
    derive_data_paths(cfg, PIPELINE_DATASET)
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    model = option_model(torch, cfg, data)
    trainer = Trainer(cfg, model)
    props = {n: dict(impl=p.impl, n=p.n_nodes, nnz=p.adj.nnz)
             for n, p in propagators(model).items()}
    for m in ("image", "text"):   # the prototypes are the card's centres
        center = np.load(os.path.join(cfg["interaction_data_path"],
                                      "mm_cluster", f"{m}_center.npy"))
        proto = getattr(model, f"{m}_prototype_embedding")
        if not torch.equal(proto.detach().cpu(), torch.from_numpy(center)):
            raise AssertionError(f"{tag}: {m} prototypes are not "
                                 f"mm_cluster/{m}_center.npy")
    graphs, hops = zoo_graphs(torch, kernels, spmm, model, tag,
                              np.random.default_rng(SEED + 12))
    checked = graph_errors(graphs)
    del graphs
    batches = draw_batches(torch, data.device_data, PIPELINE_STEPS, 512,
                           SEED + 11)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    parts = torch.stack([trainer.train_steps([b]) for b in batches])
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = spmm_launches(kernels.launches)
    parts = parts.cpu().numpy()
    want = {"spmm_csr": hops * PIPELINE_STEPS,
            "spmm_csr_bwd": hops * PIPELINE_STEPS}
    log(f"[{tag}] {PIPELINE_STEPS} Adam steps in {steps_s:.3f} s, "
        f"launches {launches} (expected {want}); propagators "
        f"{json.dumps(props)}; prototypes mm_cluster's centres "
        f"{tuple(model.image_prototype_embedding.shape)} / "
        f"{tuple(model.text_prototype_embedding.shape)}; loss parts first / "
        f"last "
        f"{parts[0].tolist()} / {parts[-1].tolist()}")
    if launches != want or not np.isfinite(parts).all() or \
            {p["impl"] for p in props.values()} != {"kernel"}:
        raise AssertionError(f"{tag}: launches {launches}, props {props}")
    return dict(steps=PIPELINE_STEPS, steps_s=steps_s, launches=launches,
                propagators=props, kernel_vs_plain=checked,
                loss_first=parts[0].tolist(),
                loss_last=parts[-1].tolist())


def phase_pipeline(torch, kernels, spmm):
    """Phase 11: (a) the raw Food.com tree, (b) preprocess_cli on the card
    and its checks, (c) the extractors on the card, (d) CIKM_Model's CLI
    for one epoch and CLUSSL for PIPELINE_STEPS steps on the output, the
    kernel held against plain on each of their graphs.
    Prints its stage times on a JSON line of its own. Returns (summary,
    {path: launches})."""
    import pickle
    import shutil

    from foodrec_tpu_torch.data import preprocess_cli

    tag = "11 pipeline"
    t_phase = time.perf_counter()
    shutil.rmtree(PIPELINE_ROOT, ignore_errors=True)
    raw = os.path.join(PIPELINE_ROOT, "raw")
    t0 = time.perf_counter()
    counts, ingre_names, titles = foodcom_raw_tree(raw)
    gen_s = time.perf_counter() - t0
    log(f"[{tag}] (a) raw Food.com tree, seed {FOODCOM_RAW['seed']}: "
        f"{json.dumps(counts)} in {gen_s:.1f} s (host); cut: no images and "
        f"no extractor weights, so --features synthesize at 2048 / 512")

    t0 = time.perf_counter()
    out = preprocess_cli.main([
        "--format", "foodcom", "--raw-dir", raw,
        "--out", os.path.join(PIPELINE_ROOT, PIPELINE_DATASET),
        "--n-clusters", str(PIPELINE_CLUSTERS), "--n-neg", str(NEG_NUM),
        "--health-sample-dict"])
    cli_s = time.perf_counter() - t0
    stage_s = out["stage_s"]
    log(f"[{tag}] (b) preprocess_cli --format foodcom: {out['n_users']} "
        f"users x {out['n_items']} items (Foodcom {FOODCOM_FOOTPRINT[0]} x "
        f"{FOODCOM_FOOTPRINT[1]}) in {cli_s:.1f} s; stages (s) "
        f"{json.dumps({k: round(v, 3) for k, v in stage_s.items()})}")
    shapes, kmeans = pipeline_outputs(torch, out)

    with open(os.path.join(out["base"], "mapping_dict.pkl"), "rb") as f:
        _, item_to_idx, ingre_to_idx = pickle.load(f)
    texts = [ingre_names[g] for g in ingre_to_idx] + \
        [titles[r] for r in item_to_idx]
    extract = pipeline_extractors(torch, texts,
                                  os.path.join(PIPELINE_ROOT, "images"))
    torch.cuda.empty_cache()

    driver_dir = os.path.join(PIPELINE_ROOT, "driver")
    os.makedirs(driver_dir)
    cwd = os.getcwd()
    os.chdir(driver_dir)
    try:
        cli = driver_cli(torch, kernels, dataset=PIPELINE_DATASET,
                         data_root=PIPELINE_ROOT, epochs=1, tag="11 cikm")
    finally:
        os.chdir(cwd)
    cikm = {k: v for k, v in cli.items() if k not in ("trainer", "ckpt")}
    # the kernel against plain on the ri and ui graphs the CLI trained on
    graphs, _ = zoo_graphs(torch, kernels, spmm, cli["trainer"].model,
                           "11 cikm", np.random.default_rng(SEED + 11))
    cikm["kernel_vs_plain"] = graph_errors(graphs)
    del cli, graphs
    torch.cuda.empty_cache()
    clussl = pipeline_clussl(torch, kernels, spmm)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    summary = dict(raw=counts, raw_s=gen_s, cli_s=cli_s, stage_s=stage_s,
                   dataset=shapes, kmeans=kmeans, extract=extract,
                   cikm_cli=cikm, clussl=clussl, phase_s=phase_s)
    log(f"[{tag}] phase {phase_s:.1f} s")
    print(json.dumps({"pipeline": summary}), flush=True)
    paths = {"pipeline CIKM_Model cli": cikm["launches"],
             f"pipeline PRICAI_ModelX {PIPELINE_STEPS} steps":
                 clussl["launches"]}
    return summary, paths


# phase 12: the flagship step of foodrec_tpu_torch.entry (the counterpart of
# __graft_entry__.entry): CIKM_Model's summed loss on the toy synthetic
ENTRY_REPS = 20       # timed steps through each path


def phase_entry(torch, kernels, card):
    """Phase 12: `entry()` on the card, `fn` forward and backward through
    the kernel with its launches counted (CIKM_Model's 1 ui + 2 ri hops: 3
    forward, 3 backward); the loss and every gradient against the same fn
    with `segment` (the same generator seed, so the same dropout); the
    step's wall time through each path."""
    from foodrec_tpu_torch.entry import entry

    tag = "12 entry"
    t_phase = time.perf_counter()
    fn, (model, batch) = entry()
    impls = {n: p.impl for n, p in propagators(model).items()}
    if set(impls.values()) != {"kernel"}:
        raise AssertionError(f"entry's propagators: {impls}")

    def step():
        model.zero_grad(set_to_none=True)
        loss = fn(model, batch)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in model.named_parameters()}

    def step_ms():
        times = []
        for _ in range(ENTRY_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    torch.cuda.synchronize()
    reset_launches(kernels)
    loss_k, grads_k = step()
    torch.cuda.synchronize()
    launches = spmm_launches(kernels.launches)
    if launches != {"spmm_csr": 3, "spmm_csr_bwd": 3}:
        raise AssertionError(f"entry step: expected 3 + 3 launches, got "
                             f"{launches}")
    if not bool(loss_k.isfinite()) or any(g is None for g in grads_k.values()):
        raise AssertionError(f"entry step: loss {loss_k} or a gradient "
                             "missing")
    ms = step_ms()
    kernel_props = swap_propagators(model, "segment")
    loss_p, grads_p = step()
    ms_p = step_ms()
    restore_propagators(model, kernel_props)
    err = check_close("entry loss", loss_k, loss_p)
    grad_err = max(check_close(f"entry grad {k}", g, grads_p[k])
                   for k, g in grads_k.items())
    phase_s = time.perf_counter() - t_phase
    log(f"[{tag}] CIKM_Model {model.n_users} users x {model.n_items} items, "
        f"batch {len(batch['u_id'])}, propagators {impls}: loss "
        f"{float(loss_k):.6f} (segment {float(loss_p):.6f}, max|d| "
        f"{err:.3e}), {len(grads_k)} gradient leaves within the bar, max|d| "
        f"{grad_err:.3e}; launches {launches}")
    log(f"[{tag}] step (forward + backward) wall median of {ENTRY_REPS}: "
        f"{ms:.3f} ms through the kernel, {ms_p:.3f} ms through segment; "
        f"phase {phase_s:.1f} s; {card}")
    return dict(loss=float(loss_k), loss_segment=float(loss_p),
                loss_err=err, grad_err=grad_err, launches=launches,
                step_ms=ms, segment_step_ms=ms_p, phase_s=phase_s)


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
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 10 (scale-out) alone")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="phases 1, 2 and 11 (the offline pipeline) alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from foodrec_tpu_torch.ops import _kernels, spmm

    card = phase_device(torch)
    phase_build(_kernels)
    if args.mesh_only:
        ensure_dataset()
        phase_mesh(torch, _kernels)
        return 0
    if args.pipeline_only:
        phase_pipeline(torch, _kernels, spmm)
        return 0
    phase_random_graphs(torch, _kernels, spmm)
    power_law = phase_power_law(torch, _kernels, spmm)
    metrics_kernel = phase_by_user_metrics(torch, _kernels)
    if args.kernels_only:
        return 0
    flagship = phase_entry(torch, _kernels, card)
    served = phase_serving(torch, _kernels, spmm)
    graphs = timed_graphs(served, power_law)
    floor = phase_floor(torch)
    per_graph = phase_times(torch, spmm, graphs)
    phase_sweep(torch, _kernels, spmm, graphs)
    trained = phase_train(torch, _kernels, spmm, served)
    bwd_graph = phase_backward_times(torch, spmm, graphs)
    zoo = phase_zoo(torch, _kernels, spmm)
    gate = phase_gate(torch)
    zoo_graphs = {k: g for z in zoo.values() for k, g in z["graphs"].items()
                  if k in TIMED_ZOO_GRAPHS}
    per_graph.update(phase_times(torch, spmm, zoo_graphs))
    bwd_graph.update(phase_backward_times(torch, spmm, zoo_graphs))
    driver = phase_driver(torch, _kernels)
    torch.cuda.empty_cache()
    options = phase_options(torch, _kernels, served["data"], {
        "CIKM_Model": (trained["epoch_s"], trained["peak_gb"],
                       trained["busy_us"]),
        "BM3": (zoo["BM3"]["epoch_s"], zoo["BM3"]["peak_gb"],
                zoo["BM3"]["busy_us"])})
    torch.cuda.empty_cache()
    mesh, mesh_paths = phase_mesh(torch, _kernels)
    torch.cuda.empty_cache()
    pipeline, pipeline_paths = phase_pipeline(torch, _kernels, spmm)
    pipeline_checks = [pipeline[k]["kernel_vs_plain"]
                       for k in ("cikm_cli", "clussl")]

    fwd_by_path = {"entry step": flagship["launches"]["spmm_csr"],
                   "serve": served["launches"],
                   "train_epoch": trained["launches"]["spmm_csr"]}
    bwd_by_path = {"entry step": flagship["launches"]["spmm_csr_bwd"],
                   "train_epoch": trained["launches"]["spmm_csr_bwd"]}
    for name, z in zoo.items():
        fwd_by_path[f"{name} serve"] = z["serve"]
        fwd_by_path[f"{name} train_epoch"] = z["train"]["spmm_csr"]
        bwd_by_path[f"{name} train_epoch"] = z["train"]["spmm_csr_bwd"]
    predict_s, predict_launches, predict_bitwise = zoo["SCHGN"][
        "full_sort_predict"]
    fwd_by_path["SCHGN full_sort_predict"] = predict_launches["spmm_csr"]
    for path, launches in (("driver cli", driver["cli"]["launches"]),
                           ("mg train_epoch", driver["mg"]["launches"])):
        fwd_by_path[path] = launches["spmm_csr"]
        bwd_by_path[path] = launches["spmm_csr_bwd"]
    fwd_by_path["full_sort test"] = driver["full_sort"]["launches"]
    fwd_by_path["sample test"] = driver["sample"]["launches"]
    option_paths = [
        ("health padded train_epoch", options["health"]["launches"]),
        *((f"{name} {OPTION_STEPS} steps", o["launches"])
          for name, o in options["learners"].items()),
        *((f"frozen {name} train_epoch", o["launches"])
          for name, o in options["frozen"].items()),
        ("LightGCN fit with trace", options["trace"]["launches"])]
    for path, launches in [*option_paths, *mesh_paths.items(),
                           *pipeline_paths.items()]:
        fwd_by_path[path] = launches["spmm_csr"]
        bwd_by_path[path] = launches["spmm_csr_bwd"]
    models = {name: dict(
        kernel_hops_per_forward=z["hops"], epoch_s=z["epoch_s"],
        epoch_steps=z["n_steps"], steps_per_s=z["n_steps"] / z["epoch_s"],
        peak_memory_gib=z["peak_gb"], evaluate_s=z["eval_s"],
        topk_block_s=z["topk_s"], topk_peak_memory_gib=z["topk_peak_gb"],
        busy_share_20_steps=z["busy_share"], metrics=z["metrics"])
        for name, z in zoo.items()}
    models["SCHGN"]["full_sort_predict"] = dict(
        users=TOPK_USERS, s=predict_s, bitwise_to_score_items=predict_bitwise)
    record = {"kernels": [
        kernel_entry(
            per_graph, "launches_per_eval_cache", name="spmm_csr",
            replaces="foodrec_tpu/ops/spmm.py:129",
            launches=sum(fwd_by_path.values()),
            launches_by_path=fwd_by_path,
            max_abs_err=max([g["max_abs_err"] for g in per_graph.values()]
                            + [g["err"] for z in zoo.values()
                               for g in z["graphs"].values()]
                            + [c["max_abs_err"] for c in pipeline_checks]),
            per="one CIKM_Model eval_cache: 2 ri_prop hops + 1 ui_prop hop",
            evaluate_test_s=served["eval_test_s"], timing_floor=floor,
            models=models, lightgcn_gate=gate,
            driver={k: v for k, v in driver.items() if k != "resume"},
            options=options, mesh=mesh, entry=flagship,
            pipeline={k: v for k, v in pipeline.items()
                      if k in ("raw", "cli_s", "stage_s", "dataset",
                               "phase_s")}),
        kernel_entry(
            bwd_graph, "launches_per_train_step", name="spmm_csr_bwd",
            replaces="foodrec_tpu/ops/spmm.py:129 (custom VJP :263-273)",
            launches=sum(bwd_by_path.values()),
            launches_by_path=bwd_by_path,
            max_abs_err=max(trained["grad_err"], *(
                g["grad_err"] for g in power_law.values()), *(
                z["grad_err"] for z in zoo.values()), *(
                c["grad_max_abs_err"] for c in pipeline_checks),
                flagship["grad_err"]),
            per="one CIKM_Model train step: 2 ri_prop + 1 ui_prop backward "
                "hops",
            epoch_s=trained["epoch_s"], epoch_steps=trained["n_steps"],
            steps_per_s=trained["n_steps"] / trained["epoch_s"],
            busy_share_20_steps=trained["busy_share"],
            peak_memory_gib=trained["peak_gb"],
            calculate_loss_grad_max_abs_err=trained["model_grad_err"],
            driver_resume=driver["resume"]),
        {"name": "by_user_metrics", "route": "cuda",
         "source": "foodrec_tpu_torch/csrc/by_user_metrics.cu",
         "replaces": "none (foodrec_tpu/engine/evaluator.py:30 "
                     "by_user_metrics, jnp)",
         "per": "one by-user block of 256 users x 640 slots",
         "launches": sum(served["metrics_launches"].values()),
         "launches_by_path": served["metrics_launches"],
         **metrics_kernel},
    ]}
    log(card)  # again beside the results, for a reader of the output's end
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
