"""PyTorch port, SpMM: the port's plain versions (`ell`, `segment`, and the
CSR kernel's CPU path) against the JAX package's `segment` and Pallas
(interpret mode) impls on the same graphs and inputs, rtol 1e-5 / atol 1e-6
(float32 sums taken in other orders). The CUDA kernel itself runs only on the
card, where chip_smoke.py holds it against these plain versions."""

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6


def _graph(kind, rng):
    """(rows, cols, n): random edges, a hub row above ELL_DEGREE_CAP plus
    empty rows, or a bounded-degree ring."""
    if kind == "random":
        n = 61
        return rng.integers(0, n, 150), rng.integers(0, n, 150), n
    if kind == "hub+empty":
        n = 300
        rows = np.concatenate([np.zeros(200, np.int64),
                               rng.integers(1, 150, 100)])
        cols = np.concatenate([rng.choice(np.arange(1, 250), 200,
                                          replace=False),
                               rng.integers(1, 150, 100)])
        return rows, cols, n  # nodes 250..299 have no edges
    n = 40
    return np.arange(n), (np.arange(n) + 1) % n, n


def _adjs(kind, rng):
    from foodrec_tpu.ops.graph import sym_normalized_adjacency as jsym
    from foodrec_tpu_torch.ops.graph import sym_normalized_adjacency

    rows, cols, n = _graph(kind, rng)
    return sym_normalized_adjacency(rows, cols, n), jsym(rows, cols, n)


@pytest.mark.parametrize("kind", ["random", "hub+empty"])
@pytest.mark.parametrize("d", [16, 64])
def test_port_impls_match_jax_segment_and_pallas(rng, kind, d):
    from foodrec_tpu.ops.graph import ELL_DEGREE_CAP
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = _adjs(kind, rng)
    if kind == "hub+empty":
        deg = np.diff(adj.row_ptr)
        assert deg.max() > ELL_DEGREE_CAP and (deg == 0).any()
    x = rng.standard_normal((adj.n_nodes, d)).astype(np.float32)
    refs = {impl: np.asarray(JPropagator(jadj, impl=impl)(x))
            for impl in ("segment", "pallas")}
    xt = torch.from_numpy(x)
    for impl in ("ell", "segment", "kernel"):
        prop = Propagator(adj, impl=impl, device="cpu")
        got = prop(xt).numpy()
        for name, ref in refs.items():
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"port {impl} vs jax {name}")


def test_propagate_mean_matches_jax(rng):
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu.ops.spmm import propagate_mean as jmean
    from foodrec_tpu_torch.ops.spmm import Propagator, propagate_mean

    adj, jadj = _adjs("random", rng)
    x = rng.standard_normal((adj.n_nodes, 32)).astype(np.float32)
    want = np.asarray(jmean(JPropagator(jadj, impl="segment"), x, 3))
    for impl in ("segment", "kernel"):
        got = propagate_mean(Propagator(adj, impl=impl, device="cpu"),
                             torch.from_numpy(x), 3).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_auto_rule(rng):
    from foodrec_tpu_torch.ops.spmm import Propagator, select_impl

    ring, _ = _adjs("ring", rng)
    hub, _ = _adjs("hub+empty", rng)
    loose, _ = _adjs("random", rng)
    assert Propagator(ring, device="cpu").impl == "ell"
    assert Propagator(hub, device="cpu").impl == "segment"
    assert Propagator(loose, device="cpu").impl == "segment"
    # on the card, graphs that fail the ELL padding test take the kernel
    assert select_impl(hub, "auto", "cuda") == "kernel"
    assert select_impl(loose, "auto", "cuda") == "kernel"
    assert select_impl(ring, "auto", "cuda") == "ell"
    assert select_impl(hub, "ell", "cpu") == "segment"  # no ELL table
    with pytest.raises(ValueError):
        select_impl(ring, "pallas", "cpu")


def test_unported_options_raise(rng):
    """spmm_dtype bfloat16 is ported (every impl builds and computes in it;
    its parity with the JAX package is in test_torch_port_spmm_plan.py);
    dtypes the JAX package does not have raise instead of running in f32."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, _ = _adjs("random", rng)
    x = torch.from_numpy(rng.standard_normal((adj.n_nodes, 8)).astype(
        np.float32))
    for impl in ("ell", "segment", "kernel"):
        prop = Propagator(adj, impl=impl, compute_dtype="bfloat16",
                          device="cpu")
        assert prop.bf16
        y = prop(x)
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert not Propagator(adj, compute_dtype="float32", device="cpu").bf16
    for dtype in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match="spmm_dtype"):
            Propagator(adj, compute_dtype=dtype, device="cpu")


def _row_normalized_adjs(rng):
    """A graph that is not symmetric: the JAX package's row-normalized
    adjacency, and the same arrays as the port's NormalizedAdjacency."""
    from foodrec_tpu.ops.graph import row_normalized_adjacency
    from foodrec_tpu_torch.ops.graph import NormalizedAdjacency

    rows, cols, n = _graph("hub+empty", rng)
    jadj = row_normalized_adjacency(rows, cols, n)
    assert not jadj.symmetric
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(jadj.rows, minlength=n))]).astype(np.int32)
    adj = NormalizedAdjacency(
        n_nodes=n, rows=jadj.rows, cols=jadj.cols, vals=jadj.vals,
        row_ptr=row_ptr, ell_cols=jadj.ell_cols, ell_vals=jadj.ell_vals,
        max_degree=jadj.max_degree, symmetric=False)
    return adj, jadj


def _cotangent(kind, y):
    """A loss of y whose gradient reaches the SpMM as the layouts the model
    gives it: an expanded ones tensor (`sum`), rows of zeros from a slice
    (`slice`), or a dense tensor (`weighted`)."""
    if kind == "sum":
        return y.sum()
    if kind == "slice":
        return y[: y.shape[0] // 3].sum()
    w = torch.linspace(-1.0, 1.0, y.numel(), dtype=y.dtype).reshape(y.shape)
    return (y * w).sum()


@pytest.mark.parametrize("graph", ["symmetric", "row-normalized"])
@pytest.mark.parametrize("kind", ["sum", "slice", "weighted"])
def test_port_gradients_match_jax_custom_vjp(rng, graph, kind):
    """d/dx of the port's `kernel` (SpmmCSR, its plain version on the CPU),
    `segment` and `ell` against jax.vjp through the JAX package's custom VJP
    (segment, and Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = (_adjs("hub+empty", rng) if graph == "symmetric"
                 else _row_normalized_adjs(rng))
    d = 16
    x = rng.standard_normal((adj.n_nodes, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    # the cotangent of the loss with respect to y, fed to jax.vjp
    y0 = torch.zeros((adj.n_nodes, d), requires_grad=True)
    g, = torch.autograd.grad(_cotangent(kind, y0), y0)
    refs = {}
    for impl in ("segment", "pallas"):
        _, vjp = jax.vjp(JPropagator(jadj, impl=impl), jnp.asarray(x))
        refs[impl] = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    for impl in ("kernel", "segment", "ell"):
        y = Propagator(adj, impl=impl, device="cpu")(xt)
        got, = torch.autograd.grad(_cotangent(kind, y), xt)
        for name, ref in refs.items():
            np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"port {impl} vs jax {name}")


@pytest.mark.parametrize("graph", ["symmetric", "row-normalized"])
def test_kernel_impl_gradient_equals_segment(rng, graph):
    """SpmmCSR's backward runs the kernel's plain version on A^T for a CPU
    tensor: its gradient is segment autograd's, through propagate_mean's
    three hops, and the adjacency gets none. A non-symmetric graph holds
    A^T's own CSR tables; a symmetric one reuses A's."""
    from foodrec_tpu_torch.ops.spmm import Propagator, propagate_mean

    adj, _ = (_adjs("random", rng) if graph == "symmetric"
              else _row_normalized_adjs(rng))
    x = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    grads = {}
    for impl in ("kernel", "segment"):
        prop = Propagator(adj, impl=impl, device="cpu")
        xt = torch.from_numpy(x).requires_grad_(True)
        y = propagate_mean(prop, xt, 3)
        grads[impl], = torch.autograd.grad(_cotangent("weighted", y), xt)
        assert not any(b.requires_grad for b in prop.buffers())
    np.testing.assert_allclose(grads["kernel"].numpy(),
                               grads["segment"].numpy(), rtol=RTOL, atol=ATOL)
    kernel = Propagator(adj, impl="kernel", device="cpu")
    assert hasattr(kernel, "t_row_ptr") == (graph != "symmetric")


def test_kernel_wrapper_raises_without_cuda(rng, monkeypatch, tmp_path):
    """The kernel module imports without nvcc or CUDA; asking it for the card
    raises instead of falling back to the CPU."""
    from foodrec_tpu_torch.ops import _kernels
    from foodrec_tpu_torch.ops.spmm import Propagator, plan_csr

    adj, _ = _adjs("random", rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Propagator(adj, impl="kernel", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        _kernels._entry("spmm_csr")
    plan = plan_csr(adj.row_ptr)
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.spmm_csr(torch.from_numpy(adj.row_ptr),
                          torch.from_numpy(adj.cols),
                          torch.from_numpy(adj.vals),
                          plan.with_table(torch.from_numpy(plan.table)),
                          torch.zeros(adj.n_nodes, 8))
    # no toolkit: the build raises with a message instead of a silent fallback
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
