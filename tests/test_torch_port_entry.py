"""PyTorch port: `foodrec_tpu_torch.entry.entry()` against the JAX package's
`__graft_entry__.entry()`, CIKM_Model's summed loss on the toy synthetic,
with the same parameters (carried over by params_from_jax) and the
encoder's dropout set to 0 on both models.

Tolerances, relative to the JAX package's value:
  * float32: the summed loss 1e-5
  * float64 (the JAX model built under x64, the port model cast to float64
    before the parameters are loaded): the summed loss and every
    parameter's gradient 1e-9
The SpMM runs the CUDA kernel's plain version where the tensors lie on the
CPU. The float32 loss's `cuda` case builds `entry("cuda")` on the card,
where the SpMM launches the CUDA kernel, and holds it to the same JAX step
(JAX on the CPU), 1e-5.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import _buffers64
from test_torch_port_options import one_thread  # noqa: F401
from test_torch_port_schgn import _grad_err
from test_torch_port_train import _rel_err
from torch_port_fixtures import device  # noqa: F401


@pytest.fixture(scope="module")
def graft_entry(tmp_path_factory):
    """`__graft_entry__.entry` with its model's dropout at 0, its toy data
    in a temporary directory of the test run; returns
    (jax model, fn, (params, batch)) of a call."""
    import __graft_entry__ as graft

    root = str(tmp_path_factory.mktemp("graft"))
    setup = graft._tiny_setup

    def call():
        built = {}

        def tiny_setup(**kw):
            cfg, data, model = setup(**kw)
            model.attn_dropout = 0.0
            built["model"] = model
            return cfg, data, model

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graft, "_tiny_setup", tiny_setup)
            mp.setattr(tempfile, "gettempdir", lambda: root)
            fn, args = graft.entry()
        return built["model"], fn, args

    return call


@pytest.fixture(scope="module")
def graft32(graft_entry):
    return graft_entry()


def _port_entry(jparams, dtype=torch.float32, device="cpu"):
    from foodrec_tpu_torch.entry import entry
    from foodrec_tpu_torch.utils.weights import params_from_jax

    fn, (model, batch) = entry(device)
    model.attn_dropout = 0.0
    model.to(dtype)
    # after .to(dtype): under x64 some JAX leaves are float64 draws
    model.load_state_dict(params_from_jax(jax.device_get(jparams), model))
    return fn, model, dict(batch, weight=batch["weight"].to(dtype))


def test_entry_batch_and_model(graft32):
    """The same toy set-up and batch: the port's synthetic is the JAX
    package's, and its train pairs lead the batch."""
    _, _, (jparams, jbatch) = graft32
    fn, model, batch = _port_entry(jparams)
    for k in ("u_id", "pos_i_id", "neg_i_id", "weight"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]),
                                      err_msg=k)
    assert (model.n_users, model.n_items) == (32, 64)
    assert model.device.type == "cpu"
    loss = fn(model, batch)
    assert loss.ndim == 0 and loss.requires_grad
    assert torch.equal(loss, fn(model, batch))  # fn seeds its own generator


def test_entry_loss_matches_jax_float32(graft32, device):
    from foodrec_tpu_torch.ops import _kernels

    _, jfn, (jparams, jbatch) = graft32
    want = float(jax.jit(jfn)(jparams, jbatch))
    fn, model, batch = _port_entry(jparams, device=device)
    before = _kernels.launches["spmm_csr"]
    got = fn(model, batch).detach()
    assert got.dtype == torch.float32
    if device == "cuda":  # CIKM_Model's 1 ui + 2 ri hops through the kernel
        assert {p.impl for p in (model.ui_prop, model.ri_prop)} == {"kernel"}
        assert _kernels.launches["spmm_csr"] - before == 3
    err = _rel_err(float(got), want)
    assert err <= 1e-5, f"summed loss: relative error {err:.3e}"


def test_entry_loss_and_grads_match_jax_float64(graft_entry):
    """The JAX step built and differentiated under x64 (one jit), its
    buffers bound as float64, against the port in float64."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    with jax.enable_x64(True):
        jmodel, jfn, (jparams, jbatch) = graft_entry()
        params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                jparams)
        jbatch = dict(jbatch, weight=jnp.asarray(jbatch["weight"],
                                                 jnp.float64))

        def bound(params, buffers):
            with jmodel.bind(buffers):
                return jfn(params, jbatch)

        want, jgrads = jax.jit(jax.value_and_grad(bound))(
            params64, _buffers64(jmodel))
        want, jflat = float(want), flatten_params(jax.device_get(jgrads))
    fn, model, batch = _port_entry(jparams, torch.float64)
    loss = fn(model, batch)
    assert loss.dtype == torch.float64
    loss.backward()
    err = _rel_err(float(loss.detach()), want)
    assert err <= 1e-9, f"summed loss: relative error {err:.3e}"
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(jflat)
    worst = max(_grad_err(k, p.grad.numpy(), jflat) for k, p in grads.items())
    assert worst <= 1e-9, f"gradients: relative error {worst:.3e}"


def test_entry_asks_for_cuda(monkeypatch):
    from foodrec_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
