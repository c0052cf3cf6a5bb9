# coding: utf-8
"""Build, load and launch the port's hand-written CUDA kernels.

Each source under `foodrec_tpu_torch/csrc/` is compiled with `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use, into
`build/kernels/` at the repository root (gitignored), keyed by a hash of the
source and the flags; the library is bound with `ctypes`. `build()` starts
one `nvcc` per source, all at once. Nothing is compiled or loaded at import,
so this module imports on machines without CUDA or `nvcc`.

A launcher checks device, dtype, shape, contiguity and alignment, raises on
anything its kernel does not take, launches on PyTorch's current stream,
raises if the launch reports an error, and adds one to its kernel's launch
count (`launches`) -- nowhere else.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
# kernel name -> (source under csrc/, C entry point, its ctypes argtypes)
KERNELS = {
    "spmm_csr": ("spmm_csr.cu", "spmm_csr_f32",
                 [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 6
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "by_user_metrics": ("by_user_metrics.cu", "by_user_metrics_f32",
                        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                        + [ctypes.c_int, ctypes.c_void_p]),
    "gather_rows_bwd": ("gather_rows_bwd.cu", "gather_rows_bwd_f32",
                        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launch counts since the caller last reset them: one per kernel, and
# `spmm_csr_bwd` for the launches of spmm_csr that compute a gradient
launches = {**{name: 0 for name in KERNELS}, "spmm_csr_bwd": 0}

_libs = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    path = path if os.path.isfile(path) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels build only where the toolkit is")
    return path


def _library_path(name):
    with open(os.path.join(_CSRC, KERNELS[name][0]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None, ptxas_verbose=False):
    """Compile the named kernels (default: all) that are not built yet, one
    `nvcc` process each, all started together. Returns {name: compiler
    output} for the kernels it compiled; raises if any build fails."""
    nvcc = None
    procs = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names or KERNELS:
        out = _library_path(name)
        if os.path.isfile(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp, os.path.join(_CSRC, KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _entry(name):
    """The kernel's C entry point, built and loaded on first use."""
    if name not in _libs:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name} needs CUDA, which is not available")
        build([name])
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(_library_path(name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return _libs[name]


def load_all():
    """Build (in parallel) and load every kernel."""
    build()
    for name in KERNELS:
        _entry(name)


def _check(cond, msg, kernel="spmm_csr"):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def spmm_csr(row_ptr, cols, vals, plan, x, count="spmm_csr",
             round_bf16=False):
    """y = A @ x on the card: A in CSR (row_ptr int32 [n+1], cols int32
    [nnz], vals float32 [nnz]) with its work plan (`ops.spmm.plan_csr`, the
    CsrPlan's table an int32 tensor on x's device), x float32 [n_cols, d]
    contiguous with d even. `round_bf16` rounds x to bf16 in the kernel; the
    sums and y stay float32. Column ids are trusted to lie in [0, n_cols)
    (the graph builders make them so). One product may take two launches (a
    fix-up kernel adds the slices of cut rows); it adds one to
    `launches[count]`: "spmm_csr" for a forward product, "spmm_csr_bwd" for
    a gradient (A^T @ g)."""
    dev = x.device
    _check(dev.type == "cuda", f"x must be on a CUDA device, got {dev}")
    table = plan.table
    for t, name in ((row_ptr, "row_ptr"), (cols, "cols"), (vals, "vals"),
                    (table, "plan table")):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{name} must be a tensor on {dev}")
        _check(t.dim() == 1 and t.is_contiguous(),
               f"{name} must be 1-D contiguous")
    _check(row_ptr.dtype == torch.int32 and cols.dtype == torch.int32
           and table.dtype == torch.int32,
           "row_ptr, cols and the plan table must be int32")
    _check(vals.dtype == torch.float32 and x.dtype == torch.float32,
           "vals and x must be float32")
    _check(cols.numel() == vals.numel(), "cols and vals differ in length")
    _check(cols.numel() < 2 ** 31, "nnz must be below 2^31")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be 2-D contiguous")
    n, d = row_ptr.numel() - 1, x.shape[1]
    _check(n >= 0, "row_ptr must hold n+1 entries")
    _check(d % 2 == 0, f"d must be even, got {d}")
    _check(x.data_ptr() % 8 == 0, "x must be 8-byte aligned")
    _check(count in launches, f"unknown launch count {count!r}")
    n_items, n_fix = plan.n_items, plan.n_fix
    _check(table.numel() == 3 * n_items + 2 * n_fix + 3
           and plan.n_rows == n and plan.nnz == cols.numel(),
           "the plan does not fit its table or the matrix")
    threads = 16 * plan.items_per_block  # a half-warp per item
    _check(threads in range(32, 513, 32),
           "items_per_block must be even, 2 to 32")
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return y
    partials = torch.empty((plan.n_partials, d),
                           dtype=torch.float32, device=dev)
    # float4 lanes where x allows them (y and the scratch come from the
    # caching allocator, 512-byte aligned)
    vec = 4 if d % 4 == 0 and x.data_ptr() % 16 == 0 else 2
    fn = _entry("spmm_csr")
    ptr = [t.data_ptr() for t in (plan.item_row, plan.item_edge,
                                  plan.item_slot, plan.fix_row, plan.fix_ptr)]
    with torch.cuda.device(dev):
        err = fn(row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), *ptr, y.data_ptr(), partials.data_ptr(),
                 n_items, n_fix, d, threads, plan.block_edges,
                 plan.block_rows, vec, int(round_bf16),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr launch failed with CUDA error {err}")
    launches[count] += 1
    return y


# the widest row by_user_metrics takes: a row stages 8 bytes a slot in
# shared memory, within the 227 KB a block may use on Hopper
METRICS_MAX_WIDTH = 28 * 1024


def by_user_metrics(scores, n_pos, n_cand, gains, neg_num, masked_key):
    """The by-user metrics of a block of users on the card, one launch:
    scores float32 [B, C] contiguous with 20 <= C <= METRICS_MAX_WIDTH,
    n_pos and n_cand int64 [B] contiguous on its device (positives occupy
    slots [0, n_pos), valid slots are [0, n_cand)), `gains` the 20 float32
    rank gains 1 / log2(r + 2) in a contiguous CPU tensor, `masked_key` the
    order key of the score a slot at or past n_cand takes. Returns float32
    [B, 5], the columns auc, recall@10, recall@20, ndcg@10, ndcg@20; adds
    one to `launches["by_user_metrics"]`."""
    def check(cond, msg):
        _check(cond, msg, "by_user_metrics")

    dev = scores.device
    check(dev.type == "cuda", f"scores must be on a CUDA device, got {dev}")
    check(scores.dtype == torch.float32 and scores.dim() == 2
          and scores.is_contiguous(), "scores must be float32 2-D contiguous")
    b, c = scores.shape
    check(20 <= c <= METRICS_MAX_WIDTH,
          f"a row holds 20 to {METRICS_MAX_WIDTH} slots, got {c}")
    for t, name in ((n_pos, "n_pos"), (n_cand, "n_cand")):
        check(isinstance(t, torch.Tensor) and t.device == dev
              and t.dtype == torch.int64 and t.shape == (b,)
              and t.is_contiguous(),
              f"{name} must be int64 [{b}] contiguous on {dev}")
    check(gains.device.type == "cpu" and gains.dtype == torch.float32
          and gains.shape == (20,) and gains.is_contiguous(),
          "gains must be float32 [20] contiguous on the CPU")
    out = torch.empty((b, 5), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    fn = _entry("by_user_metrics")
    with torch.cuda.device(dev):
        err = fn(scores.data_ptr(), n_pos.data_ptr(), n_cand.data_ptr(),
                 gains.data_ptr(), out.data_ptr(), b, c, int(neg_num),
                 int(masked_key), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"by_user_metrics launch failed with CUDA error {err}")
    launches["by_user_metrics"] += 1
    return out


# sorted positions a tile of gather_rows_bwd.cu's first pass: the scratch
# is sized by it, and the kernel refuses a launch unless it is its kTile
GATHER_TILE = 32


def gather_rows_bwd(g, sid, order, n_rows):
    """The gradient of rows = table[idx] with respect to a table of
    `n_rows` rows, on the card: g float32 [n, d] contiguous, the rows'
    gradient in idx's flattened order; sid int32 [n] and order int64 [n],
    the ids in stable sorted order and the position of each
    (`torch.sort(ids, stable=True)`), on g's device. Returns float32
    [n_rows, d], every row written: zeros where no id names it. Two kernels
    a call, no atomics and no host sync; adds one to
    `launches["gather_rows_bwd"]`."""
    def check(cond, msg):
        _check(cond, msg, "gather_rows_bwd")

    dev = g.device
    check(dev.type == "cuda", f"g must be on a CUDA device, got {dev}")
    check(g.dtype == torch.float32 and g.dim() == 2 and g.is_contiguous(),
          "g must be float32 2-D contiguous")
    n, d = g.shape
    check(sid.device == dev and order.device == dev
          and sid.dtype == torch.int32 and order.dtype == torch.int64
          and sid.shape == (n,) and order.shape == (n,)
          and sid.is_contiguous() and order.is_contiguous(),
          f"sid must be int32 [{n}] and order int64 [{n}], contiguous "
          f"on {dev}")
    check(0 <= n_rows < 2 ** 31 - 1 and n < 2 ** 31 - 1,
          "ids and rows must number below 2^31 - 1")
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    if n == 0:
        return out.zero_()
    n_tiles = -(-n // GATHER_TILE)
    # the tile parts, float32 [2 * n_tiles, d], then row_ptr int32
    # [n_rows + 1]; from the caching allocator, 512-byte aligned
    scratch = torch.empty(2 * n_tiles * d + n_rows + 1, dtype=torch.int32,
                          device=dev)
    ptr = g.data_ptr()
    vec = (4 if d % 4 == 0 and ptr % 16 == 0
           else 2 if d % 2 == 0 and ptr % 8 == 0 else 1)
    fn = _entry("gather_rows_bwd")
    with torch.cuda.device(dev):
        err = fn(ptr, sid.data_ptr(), order.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), n, n_rows, d, vec, GATHER_TILE,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gather_rows_bwd launch failed with CUDA error {err}")
    launches["gather_rows_bwd"] += 1
    return out
