"""The benchmark's tests: on the CPU at a tiny size through the port's
plain paths, and, marked `cuda`, on the card.

    python3 -m pytest portbench/tests -q

A `cuda` test decides inside its fixture, never at import, that no card is
present, and skips.
"""

import pytest

# a dataset of the configurations' contract at a size a test holds
TINY = dict(n_users=60, n_items=200, n_ingredients=40, n_cal_levels=4,
            n_health_levels=6, n_clusters=5, img_dim=32, txt_dim=16,
            neg_num=30, train_per_user=(5, 9), valid_per_user=(1, 3),
            test_per_user=(2, 4), seed=7)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


@pytest.fixture
def tiny_cell(cache_dir, monkeypatch):
    """tiny_cell(name): the cell of BENCHMARK.json at the TINY size, its
    caches in a temporary directory."""
    import torch

    from portbench import harness

    monkeypatch.setattr(harness, "CACHE", cache_dir)
    torch.set_num_threads(1)

    def make(name):
        cell = harness.Cell(name)
        cell.config["data"]["params"] = dict(TINY)
        mc = cell.config["model_config"]
        mc.update(train_batch_size=64, eval_batch_size=16, neg_sample_num=30)
        if cell.traffic["kind"] == "topk":
            cell.traffic.update(users_per_request=8, item_chunk=64, k=10,
                                sample_requests=4)
        return cell

    return make
