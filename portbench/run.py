"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs. Set-up
builds the cell's program (foodrec_tpu_torch) from the seed and warms up
every shape its traffic uses; the window drives the traffic for `--seconds`;
then the plain reference judges what the window's path produced. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics, read from a torch.profiler trace of a further window of
TRACE_SECONDS), `device`, with `--trace 1` `breakdown`, and last `checks`,
each compared number with its limit. The compared numbers are also the last
lines of standard error.

The run exits with a code other than 0 and prints no result where CUDA or
the cell's GPUs are missing, where the program is missing, and where a JAX
module or the JAX package is loaded once the window has closed.
"""

import time

_START = time.perf_counter()

import os  # noqa: E402

# load from one process with few threads: the work is on the device, and
# host threads beside the one that drives it only add noise to its pace
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import trace as tracing  # noqa: E402

TRACE_SECONDS = 3.0


def _traced_window(run, modules):
    """The traffic under torch.profiler for TRACE_SECONDS, with each
    per-layer metric's instrumentation on: (counts, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    ctx = run.ctx
    acts = [ProfilerActivity.CPU]
    if ctx.device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    undo = [m.instrument(run) for m in modules if hasattr(m, "instrument")]
    try:
        with profile(activities=acts) as prof:
            counts = ctx.cell.kind.window(ctx, run.state, TRACE_SECONDS)
    finally:
        for u in undo:
            u()
    os.makedirs(harness.CACHE, exist_ok=True)
    path = os.path.join(harness.CACHE, "trace.json")
    prof.export_chrome_trace(path)
    try:
        tr = tracing.Trace.load(path)
    finally:
        os.remove(path)
    return counts, tr


def _smi_lines(rows):
    if not rows:
        return "[smi] no readings of nvidia-smi beside the window"
    cols = list(zip(*rows))

    def span(v):
        return f"{min(v)}/{statistics.median(v)}/{max(v)}"

    return (f"[smi] beside the window, {len(rows)} readings, min/median/max:"
            f" SM clock MHz {span(cols[0])}, power W {span(cols[1])}, "
            f"temperature C {span(cols[2])}")


def measure(cell_name, seed, seconds, traced, device="cuda", start=None,
            cell=None):
    """One run of one cell: the result object (without printing it).
    `cell`, a harness.Cell, stands in for the one BENCHMARK.json names."""
    harness.cache_environment()
    cell = cell or harness.Cell(cell_name)
    t = time.perf_counter()
    ctx = harness.Context(cell, seed, device)
    harness.log(f"[setup] dataset ready in {time.perf_counter() - t:.3f} s")
    kind = cell.kind
    t = time.perf_counter()
    st = kind.setup(ctx)
    harness.log(f"[setup] program built and warmed up in "
                f"{time.perf_counter() - t:.3f} s")
    smi = harness.SmiSampler() if device != "cpu" else None
    win = kind.window(ctx, st, seconds)
    samples = smi.stop() if smi else []
    run = types.SimpleNamespace(
        cell=cell, ctx=ctx, state=st, window=win, shapes=ctx.shapes,
        setup_s=win["t_start"] - (start if start is not None else _START),
        traced=None, trace=None, spmm_calls=[], graphs=None)
    harness.log(f"[window] {cell_name} seed {seed}: setup {run.setup_s:.3f} s,"
                f" window {win['window_s']:.3f} s, {win['units']} units")
    if device != "cpu":
        harness.log(_smi_lines(samples))
        dev = harness.device_record(cell.chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0, "power_limit_w": None}

    names = [m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)]
    modules = {n: cell.metric_module(n) for n in names}
    if traced:
        t = time.perf_counter()
        run.traced, run.trace = _traced_window(run, modules.values())
        harness.log(f"[trace] traced window and its reading "
                    f"{time.perf_counter() - t:.3f} s")
        dev["busy_s"] = tracing.busy_seconds(run.trace)
        dev["window_s"] = run.traced["window_s"]

    kind.release(st)
    gc.collect()
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()

    from portbench.reference import plain

    t = time.perf_counter()
    data = plain.load_dataset(os.path.join(ctx.data_root,
                                           cell.config["data"]["name"]))
    run.graphs = cell.flops.graphs(data)
    try:
        checks = kind.check(ctx, st, data)
    except Exception:  # the comparison itself failed: not correct
        harness.log(traceback.format_exc())
        checks = [("check_completed", 1, 0)]
    harness.log(f"[check] reference read the dataset and judged the run in "
                f"{time.perf_counter() - t:.3f} s")

    metrics = {}
    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    for n, mod in modules.items():
        value = mod.read(run)
        if value is not None:
            metrics[n] = {"value": float(value), "unit": units[n]}
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": win["units"],
        "failed": 0,
        "metrics": metrics,
        "device": dev,
    }
    if traced:
        harness.log(_attribution(run))
        result["breakdown"] = tracing.breakdown(run.trace)
    result["checks"] = {n: {"value": float(v), "limit": float(lim)}
                        for n, v, lim in checks}
    return result


def _attribution(run):
    """How far PyTorch's ranges and the benchmark's account for the busy
    time of the traced window."""
    tr = run.trace
    busy = tracing.busy_seconds(tr)
    parts = {p: tracing.device_seconds_under(tr, p) for p in (
        "autograd::engine::evaluate_function:", "Optimizer.step#",
        "portbench::")}
    return ("[trace] busy " + repr(busy) + " s of " + repr(run.traced[
        "window_s"]) + " s; device s under " + ", ".join(
        f"{k} {v!r}" for k, v in parts.items()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    chips = harness.Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"available: {torch.cuda.is_available()}, count "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    foreign = harness.foreign_modules()
    if foreign:
        harness.log(f"loaded in the run's process: {', '.join(foreign)}; "
                    "the benchmark measures the port alone")
        return 4
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
