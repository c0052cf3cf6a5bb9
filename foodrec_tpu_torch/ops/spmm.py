# coding: utf-8
"""SpMM y = A @ x for a normalized sparse adjacency A (counterpart of
`foodrec_tpu/ops/spmm.py`).

Three implementations behind one `Propagator` module:

  * `ell`      -- padded neighbour-table gather and weighted sum, plain torch.
                  Chosen when the padding is small (n * max_degree <= 1.5 nnz).
  * `segment`  -- sorted-COO gather + `index_add_`, plain torch.
  * `kernel`   -- the hand-written CUDA CSR SpMM (csrc/spmm_csr.cu), the port
                  of the Pallas kernel `_spmm_pallas_kernel`, inside the
                  autograd Function `SpmmCSR`: the forward is the kernel on A,
                  the backward the same kernel on A^T (A itself for a
                  symmetric graph), as the JAX package's custom VJP does
                  (foodrec_tpu/ops/spmm.py:255-276). On a CPU tensor both run
                  the plain CSR version instead; on a CUDA tensor they launch
                  the kernel or raise.

`ell` and `segment` are the kernel's plain versions, differentiated by plain
torch autograd: the CPU tests use them and `chip_smoke.py` holds the kernel
against them on the card, forward and backward.

`compute_dtype="bfloat16"` follows the JAX package per impl
(foodrec_tpu/ops/spmm.py:315-336): the kernel rounds x (g in the backward)
to bf16 and keeps the values, the sums and y in f32, as the Pallas path
does; `ell` and `segment` compute in bf16 and cast the result back to x's
dtype.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from foodrec_tpu_torch.ops import _kernels
from foodrec_tpu_torch.ops.graph import transpose_adjacency
from foodrec_tpu_torch.utils.device import resolve_device
from foodrec_tpu_torch.utils.trace import span

# The CUDA kernel's work items (plan_csr), chosen at the main path's shapes
# on the H100 among the geometries that chip_smoke.py times (PERF.md).
ITEM_EDGES = 64        # longer rows are cut into slices of at most this many
ITEM_ROWS = 32         # most whole rows in one item
ITEMS_PER_BLOCK = 8    # half-warps per thread block: 128 threads
UNROLL = 8             # row gathers a half-warp issues at once (4 or 8)


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """The CUDA kernel's work items for one CSR matrix, as one int32 `table`
    (numpy on the host, a tensor on the card) of five parts:

      item_row  [n_items + 1]  first row of each item, then n
      item_edge [n_items + 1]  first edge of each item, then nnz
      item_slot [n_items]      the partial-sum row of a slice of a cut row,
                               -1 for an item of whole rows
      fix_row   [n_fix]        the cut rows, in order
      fix_ptr   [n_fix + 1]    cut row i's partials are fix_ptr[i]:fix_ptr[i+1]

    Items cover the edges in order, each edge once, and every row: an item of
    whole rows holds rows item_row[i]:item_row[i+1]; a slice holds edges
    item_edge[i]:item_edge[i+1] of row item_row[i]. `block_edges` and
    `block_rows` are the most edges and rows the items of one block of
    `items_per_block` cover (the kernel's shared memory); `unroll` is the
    number of row gathers a half-warp issues at once."""

    table: object
    n_rows: int
    nnz: int
    n_items: int
    n_fix: int
    n_partials: int
    items_per_block: int
    block_edges: int
    block_rows: int
    unroll: int

    def _part(self, start, length):
        return self.table[start:start + length]

    @property
    def item_row(self):
        return self._part(0, self.n_items + 1)

    @property
    def item_edge(self):
        return self._part(self.n_items + 1, self.n_items + 1)

    @property
    def item_slot(self):
        return self._part(2 * self.n_items + 2, self.n_items)

    @property
    def fix_row(self):
        return self._part(3 * self.n_items + 2, self.n_fix)

    @property
    def fix_ptr(self):
        return self._part(3 * self.n_items + 2 + self.n_fix, self.n_fix + 1)

    def with_table(self, table):
        return dataclasses.replace(self, table=table)


def plan_csr(row_ptr, item_edges=ITEM_EDGES, item_rows=ITEM_ROWS,
             items_per_block=ITEMS_PER_BLOCK, unroll=UNROLL):
    """Cut a CSR matrix's work into items of about equal edge count, on the
    host, once (the counterpart of the Pallas grid's `_panelize`, JAX
    foodrec_tpu/ops/spmm.py:97-126). A row of more than `item_edges` edges
    is cut into ceil(deg / item_edges) slices of near-equal length; the other
    rows are packed whole, in order and greedily: an item takes rows while
    they fit in `item_edges` edges and `item_rows` rows. Returns a CsrPlan
    with a numpy table."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = len(row_ptr) - 1
    deg = np.diff(row_ptr)
    cut = deg > item_edges
    cut_rows = np.flatnonzero(cut)
    starts, r = [], 0  # the rows that begin an item; one step per item
    while r < n:
        starts.append(r)
        if cut[r]:
            r += 1
            continue
        fit = np.searchsorted(row_ptr, row_ptr[r] + item_edges, "right") - 1
        i = np.searchsorted(cut_rows, r)
        next_cut = cut_rows[i] if i < len(cut_rows) else n
        r = max(r + 1, min(fit, r + item_rows, next_cut))
    starts = np.asarray(starts, dtype=np.int64)
    pieces = np.where(cut[starts], -(-deg[starts] // item_edges), 1)
    item_row = np.repeat(starts, pieces)
    # slice k of K of a row of D edges begins at edge D * k // K
    k = np.arange(len(item_row)) - np.repeat(np.cumsum(pieces) - pieces,
                                             pieces)
    item_edge = (row_ptr[item_row]
                 + deg[item_row] * k // np.repeat(pieces, pieces))
    is_slice = cut[item_row]
    item_slot = np.where(is_slice, np.cumsum(is_slice) - 1, -1)
    fix_row = starts[cut[starts]]
    fix_ptr = np.concatenate([[0], np.cumsum(pieces[cut[starts]])])
    item_row = np.append(item_row, n)
    item_edge = np.append(item_edge, row_ptr[-1])
    n_items = len(item_slot)
    first = np.arange(0, n_items, items_per_block)
    last = np.minimum(first + items_per_block, n_items)
    table = np.concatenate([item_row, item_edge, item_slot, fix_row, fix_ptr])
    return CsrPlan(
        table=table.astype(np.int32), n_rows=n, nnz=int(row_ptr[-1]),
        n_items=n_items, n_fix=len(fix_row), n_partials=int(fix_ptr[-1]),
        items_per_block=items_per_block,
        block_edges=int(np.max(item_edge[last] - item_edge[first], initial=0)),
        block_rows=int(np.max(item_row[last] - item_row[first], initial=0)),
        unroll=unroll)


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
    `spmm_coo`, with the values in x's dtype."""
    n = row_ptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long())
    return spmm_coo(rows, cols.long(), vals.to(x.dtype), x, n)


def spmm_csr(row_ptr, cols, vals, plan, x, count="spmm_csr",
             round_bf16=False):
    """y = A @ x for CSR A with its CsrPlan (table on x's device): the CUDA
    kernel for a CUDA x (counted under `count`), its plain version for a CPU
    x (which needs no plan). `round_bf16` rounds x to bf16 first and keeps
    the sums in x's dtype. No autograd: see SpmmCSR."""
    if x.device.type == "cpu":
        if round_bf16:
            x = x.to(torch.bfloat16).to(x.dtype)
        return spmm_csr_plain(row_ptr, cols, vals, x)
    return _kernels.spmm_csr(row_ptr, cols, vals, plan, x, count=count,
                             round_bf16=round_bf16)


class SpmmCSR(torch.autograd.Function):
    """y = A @ x with d/dx = A^T @ g, both through `spmm_csr`; `a` and `a_t`
    are (row_ptr, cols, vals, plan) of A and A^T. The adjacency gets no
    gradient. For a symmetric A the caller passes A's own tables as A^T's
    (no second table, no copy). In bf16 mode g is rounded as x is, as under
    the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, a, a_t, round_bf16):
        ctx.a_t, ctx.round_bf16 = a_t, round_bf16
        return spmm_csr(*a, x, round_bf16=round_bf16)

    @staticmethod
    def backward(ctx, g):
        # g may arrive strided or as an expanded zero tensor (the slices of a
        # propagated table); the kernel takes a contiguous x
        with span("spmm_backward"):
            gx = spmm_csr(*ctx.a_t, g.contiguous(), count="spmm_csr_bwd",
                          round_bf16=ctx.round_bf16)
        return gx, None, None, None


def select_impl(adj, impl, device):
    """Resolve impl="auto" (foodrec_tpu/ops/spmm.py:238-253): ELL when its
    padding is small, else the CUDA kernel on the card and `segment` on the
    CPU. "pallas", the JAX package's name for its SpMM kernel, is the
    kernel here, so a config of the JAX package carries over."""
    if impl == "pallas":
        impl = "kernel"
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
    of the state_dict. The kernel impl also holds its work plan (`plan_csr`)
    and A^T's CSR tables and plan for its backward, built once on the host
    unless A is symmetric. `compute_dtype`: None or "float32", or
    "bfloat16".

    The values keep the adjacency's own dtype on the CPU, so a float64 graph
    (gcn_conv_adjacency) stays unrounded for a model cast to float64; on the
    card they are rounded once to float32, the kernel's type, as the JAX
    package's device arrays are without x64."""

    def __init__(self, adj, impl="auto", compute_dtype=None, device="cuda"):
        super().__init__()
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unknown spmm_dtype {compute_dtype!r}: null "
                             "or 'float32', or 'bfloat16'")
        self.bf16 = compute_dtype == "bfloat16"
        device = resolve_device(device)
        self.n_nodes = adj.n_nodes
        self.adj = adj  # host-side; lets a caller rebuild it with another impl
        self.impl = select_impl(adj, impl, device)
        vals_dtype = (torch.float32 if device.type == "cuda"
                      else torch.as_tensor(adj.vals).dtype)

        def buf(name, arr, dtype):
            self.register_buffer(
                name, torch.as_tensor(arr).to(device=device, dtype=dtype),
                persistent=False)

        if self.impl == "ell":
            buf("ell_cols", adj.ell_cols, torch.int64)
            buf("ell_vals", adj.ell_vals, vals_dtype)
        elif self.impl == "segment":
            buf("rows", adj.rows, torch.int64)
            buf("cols", adj.cols, torch.int64)
            buf("vals", adj.vals, vals_dtype)
        else:
            buf("row_ptr", adj.row_ptr, torch.int32)
            buf("cols", adj.cols, torch.int32)
            buf("vals", adj.vals, vals_dtype)
            self.plan = plan_csr(adj.row_ptr)
            buf("plan_table", self.plan.table, torch.int32)
            if not adj.symmetric:
                adj_t = transpose_adjacency(adj)
                buf("t_row_ptr", adj_t.row_ptr, torch.int32)
                buf("t_cols", adj_t.cols, torch.int32)
                buf("t_vals", adj_t.vals, vals_dtype)
                self.t_plan = plan_csr(adj_t.row_ptr)
                buf("t_plan_table", self.t_plan.table, torch.int32)

    def csr(self, transpose=False):
        """(row_ptr, cols, vals, plan) of A, or of A^T, on the device (kernel
        impl)."""
        if transpose and not self.adj.symmetric:
            return (self.t_row_ptr, self.t_cols, self.t_vals,
                    self.t_plan.with_table(self.t_plan_table))
        return (self.row_ptr, self.cols, self.vals,
                self.plan.with_table(self.plan_table))

    def forward(self, x):
        with span("spmm_forward"):
            if self.impl == "kernel":
                return SpmmCSR.apply(x, self.csr(), self.csr(transpose=True),
                                     self.bf16)
            dtype = torch.bfloat16 if self.bf16 else x.dtype
            if self.impl == "ell":
                y = spmm_ell(self.ell_cols, self.ell_vals.to(dtype),
                             x.to(dtype))
            else:
                y = spmm_coo(self.rows, self.cols, self.vals.to(dtype),
                             x.to(dtype), self.n_nodes)
            return y.to(x.dtype)


def propagate_mean(propagator, x0, n_layers):
    """Repeated propagation with layer-mean readout -- the shared GCN recipe
    (reference: lightgcn.py:134-147)."""
    acc = x0
    x = x0
    for _ in range(n_layers):
        x = propagator(x)
        acc = acc + x
    return acc / (n_layers + 1)
