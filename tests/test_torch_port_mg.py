"""PyTorch port, Mirror Gradient: the port's `Trainer(mg=True)` against the
JAX package's MG epoch, and its replay of a batch.

  * float64 lockstep, in a subprocess with JAX_ENABLE_X64, as
    test_torch_port_train.py runs its lockstep: CIKM_Model with its shipped
    [0.5, 50] schedule, dropout 0, MG with beta 2, two JAX epochs replayed
    through the port's `train_steps` on the JAX package's batches. The bars
    of test_lockstep_epochs_match_jax: loss parts of both epochs, the
    trained model's outputs and every parameter (L2) after the first
    within 1e-5 relative; and the lr of every update equal to the JAX
    package's `lr_schedule(count)` within 1e-12 relative. MG's second
    update advances optax's count, so with four batches an epoch (MG on
    batches 0 and 2, six updates) the count reaches the next epoch's lr
    before the first epoch ends.

    Why six updates an epoch, as in the non-MG lockstep: two correct Adam
    runs part exponentially (test_lockstep_epochs_match_jax). Measured on
    this set in float64: the port against itself with every parameter
    scaled by 1 + 1e-15 parts to 5e-10 in one epoch; the JAX package and
    the port, whose gradients agree to 4e-14, part to 4.7e-6 (parameters,
    L2) in the non-MG lockstep's six updates and to 2.7e-5 in nine (MG on
    batches 0, 2 and 4 of six), with loss-part and output errors of the
    first epoch still at 3e-8 and 3e-6. The zero-initialized biases part
    first.
  * on the CPU: an MG step at dropout 0.5 equals the same two passes
    written by hand, the generator restored before the replay (bitwise);
    the batches of an epoch that take the MG step, across
    `epoch_scan_chunk` chunks; the number of updates and their lr.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from test_torch_port_train import (
    BATCH_SIZE,
    _batch,
    _jax_epoch_batches,
    _jax_loss_and_grads,
    _overrides,
    _port_loss_and_grads,
    _port_model,
    _rel_err,
)
from torch_port_fixtures import device, port_synth_root  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# beta 2 on four batches of 24: six updates an epoch, as many as the
# non-MG lockstep's epoch of six batches (module docstring)
MG = {"alpha1": 1.0, "alpha2": 0.1, "beta": 2, "train_batch_size": 24}


@pytest.fixture(scope="module")
def x64_report(synth_root):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "True",
                "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), synth_root[0]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_mg_lockstep_epochs_match_jax(x64_report):
    """Loss parts, outputs and parameters within 1e-5 (module docstring)."""
    assert "mg lockstep pass=True" in x64_report, x64_report[-2000:]


def test_mg_lr_of_every_update_matches_jax(x64_report):
    """The lr at each update is lr_schedule(optax's count) within 1e-12,
    and the count crosses an epoch inside the first epoch."""
    assert "mg lr pass=True" in x64_report, x64_report[-2000:]


def _mg_lockstep_main(root):
    """Run in the float64 subprocess: two JAX MG epochs and their replay
    through the port; print the worst relative errors and the verdicts."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import flatten_params

    assert jax.config.jax_enable_x64
    synth = (root, {"neg_num": 20})
    overrides = _overrides(MG)
    jcfg, _ = make_config(synth, model="CIKM_Model", overrides=overrides)
    assert jcfg["learning_rate_scheduler"] == [0.5, 50]
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jtrainer = JTrainer(jcfg, jmodel, mg=True)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    cfg, _, model = _port_model(synth, overrides, jparams, dtype=torch.float64)
    trainer = Trainer(cfg, model, mg=True)
    n_batches = trainer.n_batches
    assert n_batches == jtrainer.n_batches == 4
    assert 0 < trainer.n_train % MG["train_batch_size"]  # an exact tail

    lrs = []
    step = trainer.optimizer.step

    def recording_step(*args, **kwargs):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        return step(*args, **kwargs)

    trainer.optimizer.step = recording_step
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    opt_state = jtrainer.optimizer.init(params)
    buf64 = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, jmodel.buffers)
    probe = _batch(model.dd, 5)
    key = jax.random.PRNGKey(11)
    worst = {"parts": 0.0, "outputs": 0.0, "params_l2": 0.0}
    for epoch in range(2):
        key, k_epoch = jax.random.split(key)
        batches = _jax_epoch_batches(jtrainer, k_epoch)
        params, opt_state, jparts = jtrainer._epoch_fn(params, opt_state,
                                                       k_epoch)
        parts = trainer.train_steps(
            tuple(torch.as_tensor(a, dtype=torch.int64) for a in b)
            for b in batches)
        trainer.scheduler.step()
        worst["parts"] = max([worst["parts"]] + [
            _rel_err(a, b) for a, b in zip(parts.numpy(), np.asarray(jparts))])
        if epoch > 0:
            continue
        with jmodel.bind(buf64):
            jcache = jmodel.eval_cache(params)
        outs = [_rel_err(a.numpy(), b)
                for a, b in zip(model.eval_cache(), jcache)]
        probe_j, _ = _jax_loss_and_grads(jmodel, params, *probe,
                                         dtype=jnp.float64, buffers=buf64)
        probe_t, _ = _port_loss_and_grads(model, *probe)
        outs += [_rel_err(a, b) for a, b in zip(probe_t, probe_j)]
        state = model.state_dict()
        worst["outputs"] = max(outs)
        worst["params_l2"], leaf = max(
            (np.linalg.norm(state[k].numpy() - v) / np.linalg.norm(v), k)
            for k, v in flatten_params(jax.device_get(params)).items())
        worst["parts_epoch0"] = worst["parts"]
    ok = all(v <= 1e-5 for v in worst.values())
    print("mg lockstep " + " ".join(f"worst_{k}={v:.3e}"
                                    for k, v in worst.items())
          + f" worst_leaf={leaf}")
    print(f"mg lockstep pass={ok}")

    count = int(opt_state[-1].count)  # optax's ScaleByScheduleState
    per_epoch = n_batches + -(-n_batches // MG["beta"])
    want = [float(jtrainer.lr_schedule(c)) for c in range(count)]
    lr_err = max(abs(a / b - 1) for a, b in zip(lrs, want))
    crossed = lrs[per_epoch - 1] < lrs[0]
    ok = (count == trainer.n_updates == len(lrs) == 2 * per_epoch
          and lr_err <= 1e-12 and crossed)
    print(f"mg lr updates={count} per_epoch={per_epoch} worst_rel={lr_err:.3e} "
          f"crossed_in_epoch0={crossed}")
    print(f"mg lr pass={ok}")


# ---------------------------------------------------------------------------
# the port's MG step and epoch on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture()
def deterministic(monkeypatch):
    """torch's deterministic algorithms for one test (the CPU backward of
    a gather with repeated ids adds in a varying order across threads;
    cuBLAS takes them only with a fixed workspace)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _mg_model(synth_root, device="cpu", **extra):
    return _port_model(synth_root, _overrides({
        "attention_probs_dropout_prob": 0.5, "alpha1": 0.7, "alpha2": 0.1,
        "beta": 1, **extra}), device=device)


def test_mg_step_replays_the_same_dropout_draws(port_synth_root, device,
                                                deterministic):
    """`train_steps` on one MG batch at dropout 0.5 equals the two passes
    written out: Adam on alpha1 * g, the generator restored, the batch again,
    Adam on -alpha2 * g2; the loss parts are the first pass's. Without the
    restore the replay draws other masks and the parameters differ. On the
    card the draws are the CUDA generator's."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, _, model = _mg_model(port_synth_root, device)
    by_hand = {restore: copy.deepcopy(model) for restore in (True, False)}
    trainer = Trainer(cfg, model, mg=True)
    state0 = trainer.generator.get_state()
    batch = tuple(torch.as_tensor(a).to(device)
                  for a in _batch(model.dd, 3))
    parts = trainer.train_steps([batch])
    assert trainer.n_updates == 2

    for restore, m in by_hand.items():
        gen = torch.Generator(device=device).set_state(state0)
        opt = torch.optim.Adam(m.parameters(), lr=cfg["learning_rate"],
                               eps=1e-8)

        def step(scale):
            m.zero_grad(set_to_none=True)
            out = m.calculate_loss(*batch, generator=gen)
            sum(out).backward()
            for p in m.parameters():
                if p.grad is not None:
                    p.grad.mul_(scale)
            opt.step()
            return torch.stack(out).detach()

        replay_from = gen.get_state()
        first = step(cfg["alpha1"])
        if restore:
            gen.set_state(replay_from)
        step(-cfg["alpha2"])
        assert torch.equal(first, parts)
        same = all(torch.equal(a, b) for a, b in
                   zip(m.state_dict().values(), model.state_dict().values()))
        assert same == restore


@pytest.mark.parametrize("chunk", [0, 3])
def test_mg_epoch_steps_every_beta_th_batch(synth_root, chunk):
    """Batches 0, beta, 2 beta, ... of the epoch take the MG step, counted
    from the epoch's first batch across `epoch_scan_chunk` chunks, the exact
    tail at index n_batches - 1 included; an epoch makes n_batches +
    ceil(n_batches / beta) updates, each at the JAX package's
    lr_schedule(count)."""
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.engine.trainer import Trainer

    extra = {"beta": 2, "epoch_scan_chunk": chunk}
    cfg, _, model = _mg_model(synth_root, **extra)
    trainer = Trainer(cfg, model, mg=True)
    n_batches = trainer.n_batches
    assert n_batches % 2 == 0 and trainer.n_train % BATCH_SIZE  # tail is MG-free

    states, lrs = [], []
    calculate_loss = model.calculate_loss

    def recording_loss(*args, **kwargs):
        states.append(trainer.generator.get_state())
        return calculate_loss(*args, **kwargs)

    model.calculate_loss = recording_loss
    step = trainer.optimizer.step

    def recording_step():
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        step()

    trainer.optimizer.step = recording_step
    replayed = []
    for _ in range(2):
        states.clear()
        trainer.train_epoch()
        # a replay starts from its first pass's generator state; the next
        # batch's negatives move the generator on
        b, replayed_now = -1, []
        for i, state in enumerate(states):
            if i and torch.equal(state, states[i - 1]):
                replayed_now.append(b)
            else:
                b += 1
        assert b == n_batches - 1
        replayed.append(replayed_now)

    per_epoch = n_batches + n_batches // 2
    assert trainer.n_updates == len(lrs) == 2 * per_epoch
    assert replayed == [[b for b in range(n_batches) if b % 2 == 0]] * 2

    jcfg, _ = make_config(synth_root, model="CIKM_Model",
                          overrides=_overrides(extra))
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jtrainer = JTrainer(jcfg, jget_model("CIKM_Model")(jcfg, jdata), mg=True)
    assert lrs == [float(jtrainer.lr_schedule(c)) for c in range(len(lrs))]
    assert lrs[per_epoch - 1] < lrs[0]  # the next epoch's lr, a batch early


if __name__ == "__main__":
    _mg_lockstep_main(sys.argv[1])
