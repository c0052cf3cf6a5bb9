# coding: utf-8
"""SpMM y = A @ x for a normalized sparse adjacency A (counterpart of
`foodrec_tpu/ops/spmm.py`).

Three implementations behind one `Propagator` module:

  * `ell`      -- padded neighbour-table gather and weighted sum, plain torch.
                  Chosen when the padding is small (n * max_degree <= 1.5 nnz).
  * `segment`  -- sorted-COO gather + `index_add_`, plain torch.
  * `kernel`   -- the hand-written CUDA CSR SpMM (csrc/spmm_csr.cu), the port
                  of the Pallas kernel `_spmm_pallas_kernel`. On a CPU tensor
                  its wrapper runs the plain CSR version instead; on a CUDA
                  tensor it launches the kernel or raises.

`ell` and `segment` are the kernel's plain versions: the CPU tests use them
and `chip_smoke.py` holds the kernel against them on the card.
"""

import torch
from torch import nn

from foodrec_tpu_torch.ops import _kernels
from foodrec_tpu_torch.utils.device import resolve_device


def spmm_coo(rows, cols, vals, x, n_rows):
    """Sorted-COO SpMM via gather + index_add_."""
    contrib = x[cols] * vals[:, None]
    return torch.zeros((n_rows, x.shape[1]), dtype=x.dtype,
                       device=x.device).index_add_(0, rows, contrib)


def spmm_ell(ell_cols, ell_vals, x):
    """Padded neighbour-table SpMM: [N, K] gather + weighted reduction."""
    return torch.einsum("nk,nkd->nd", ell_vals, x[ell_cols])


def spmm_csr_plain(row_ptr, cols, vals, x):
    """The CUDA kernel's plain version: the same CSR inputs through
    `spmm_coo`."""
    n = row_ptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long())
    return spmm_coo(rows, cols.long(), vals, x, n)


def spmm_csr(row_ptr, cols, vals, x):
    """y = A @ x for CSR A: the CUDA kernel for a CUDA x, its plain version
    for a CPU x. The kernel has no backward yet (it arrives with training),
    so an x that needs a gradient raises instead of losing it."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "spmm_csr has no backward yet (ROADMAP: SpMM autograd.Function); "
            "call it under torch.no_grad() or use impl='segment'")
    if x.device.type == "cpu":
        return spmm_csr_plain(row_ptr, cols, vals, x)
    return _kernels.spmm_csr(row_ptr, cols, vals, x)


def select_impl(adj, impl, device):
    """Resolve impl="auto" (foodrec_tpu/ops/spmm.py:238-253): ELL when its
    padding is small, else the CUDA kernel on the card and `segment` on the
    CPU."""
    if impl == "auto":
        ell_ok = (adj.has_ell
                  and adj.n_nodes * adj.max_degree <= 1.5 * max(adj.nnz, 1))
        if ell_ok:
            return "ell"
        return "kernel" if torch.device(device).type == "cuda" else "segment"
    if impl == "ell" and not adj.has_ell:
        return "segment"
    if impl not in ("ell", "segment", "kernel"):
        raise ValueError(f"unknown spmm impl: {impl}")
    return impl


class Propagator(nn.Module):
    """y = A @ x with a chosen implementation; the edge tables are
    non-persistent buffers on `device`, so they follow `.to()` but stay out
    of the state_dict."""

    def __init__(self, adj, impl="auto", compute_dtype=None, device="cuda"):
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                f"spmm_dtype={compute_dtype!r} is not ported yet (ROADMAP: "
                "bfloat16 SpMM); only null (float32) is supported")
        device = resolve_device(device)
        self.n_nodes = adj.n_nodes
        self.adj = adj  # host-side; lets a caller rebuild it with another impl
        self.impl = select_impl(adj, impl, device)

        def buf(name, arr, dtype):
            self.register_buffer(
                name, torch.as_tensor(arr).to(device=device, dtype=dtype),
                persistent=False)

        if self.impl == "ell":
            buf("ell_cols", adj.ell_cols, torch.int64)
            buf("ell_vals", adj.ell_vals, torch.float32)
        elif self.impl == "segment":
            buf("rows", adj.rows, torch.int64)
            buf("cols", adj.cols, torch.int64)
            buf("vals", adj.vals, torch.float32)
        else:
            buf("row_ptr", adj.row_ptr, torch.int32)
            buf("cols", adj.cols, torch.int32)
            buf("vals", adj.vals, torch.float32)

    def forward(self, x):
        if self.impl == "ell":
            return spmm_ell(self.ell_cols, self.ell_vals, x)
        if self.impl == "segment":
            return spmm_coo(self.rows, self.cols, self.vals, x, self.n_nodes)
        return spmm_csr(self.row_ptr, self.cols, self.vals, x)


def propagate_mean(propagator, x0, n_layers):
    """Repeated propagation with layer-mean readout -- the shared GCN recipe
    (reference: lightgcn.py:134-147)."""
    acc = x0
    x = x0
    for _ in range(n_layers):
        x = propagator(x)
        acc = acc + x
    return acc / (n_layers + 1)
