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
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, _ = _adjs("random", rng)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Propagator(adj, compute_dtype="bfloat16", device="cpu")


def test_kernel_refuses_inputs_that_need_grad(rng):
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, _ = _adjs("random", rng)
    prop = Propagator(adj, impl="kernel", device="cpu")
    x = torch.randn(adj.n_nodes, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        prop(x)
    with torch.no_grad():
        assert prop(x).shape == (adj.n_nodes, 8)
    # the plain impls keep autograd
    assert Propagator(adj, impl="segment", device="cpu")(x).requires_grad


def test_kernel_wrapper_raises_without_cuda(rng, monkeypatch, tmp_path):
    """The kernel module imports without nvcc or CUDA; asking it for the card
    raises instead of falling back to the CPU."""
    from foodrec_tpu_torch.ops import _kernels
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, _ = _adjs("random", rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Propagator(adj, impl="kernel", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        _kernels._entry("spmm_csr")
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.spmm_csr(torch.from_numpy(adj.row_ptr),
                          torch.from_numpy(adj.cols),
                          torch.from_numpy(adj.vals),
                          torch.zeros(adj.n_nodes, 8))
    # no toolkit: the build raises with a message instead of a silent fallback
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
