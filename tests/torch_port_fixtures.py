"""Fixtures of the PyTorch port's tests that also run on the card: a test
module takes them by importing them.

    from torch_port_fixtures import device  # noqa: F401

`device` runs a test twice, on the CPU and, marked `cuda`, on the card
(skipped where there is none): `python -m pytest -m cuda
tests/test_torch_port_*.py` runs the card's cases. The port's test modules
import this module, conftest's `make_config` and each other by their
top-level names, which pytest's default import mode puts on the path, so
that no other package called `tests` on the path can shadow them.
"""

import pytest


@pytest.fixture(scope="session")
def port_synth_root(tmp_path_factory):
    """The toy dataset written by the port's own generator (byte-identical
    to conftest's `synth_root`, tests/test_torch_port_data.py): what a test
    that also runs on the card reads."""
    from foodrec_tpu_torch.data import synthetic

    root = tmp_path_factory.mktemp("port_datasets") / "Synth"
    meta = synthetic.generate(str(root))
    return str(root), meta


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.fixture
def cuda_device():
    """"cuda" where a card is present; the test skips elsewhere."""
    return _card()


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """Each test that takes it runs twice: on the CPU, and on the card
    (marked `cuda`, skipped where there is none)."""
    return _card() if request.param == "cuda" else "cpu"
