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
                 [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                 + [ctypes.c_void_p]),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel name -> number of launches since the caller last reset it
launches = {name: 0 for name in KERNELS}

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


def _check(cond, msg):
    if not cond:
        raise ValueError(f"spmm_csr: {msg}")


def spmm_csr(row_ptr, cols, vals, x):
    """y = A @ x on the card: A in CSR (row_ptr int32 [n+1], cols int32
    [nnz], vals float32 [nnz]), x float32 [n_cols, d] contiguous with d even.
    Column ids are trusted to lie in [0, n_cols) (the graph builders make
    them so)."""
    dev = x.device
    _check(dev.type == "cuda", f"x must be on a CUDA device, got {dev}")
    for t, name in ((row_ptr, "row_ptr"), (cols, "cols"), (vals, "vals")):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
        _check(t.dim() == 1 and t.is_contiguous(),
               f"{name} must be 1-D contiguous")
    _check(row_ptr.dtype == torch.int32 and cols.dtype == torch.int32,
           "row_ptr and cols must be int32")
    _check(vals.dtype == torch.float32 and x.dtype == torch.float32,
           "vals and x must be float32")
    _check(cols.numel() == vals.numel(), "cols and vals differ in length")
    _check(cols.numel() < 2 ** 31, "nnz must be below 2^31")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be 2-D contiguous")
    n, d = row_ptr.numel() - 1, x.shape[1]
    _check(n >= 0, "row_ptr must hold n+1 entries")
    _check(d % 2 == 0, f"d must be even, got {d}")
    _check(x.data_ptr() % 8 == 0, "x must be 8-byte aligned")
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return y
    fn = _entry("spmm_csr")
    with torch.cuda.device(dev):
        err = fn(row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), n, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr launch failed with CUDA error {err}")
    launches["spmm_csr"] += 1
    return y
