"""The control on the card comes out as not correct against each cell's
limits: the plain reference put in the program's place and computed with
TF32 on (the precision below the configurations' float32), or for the
evaluation cell, whose path TF32 leaves as it is, the program's own
bfloat16 SpMM; for the training cells the half-batch and unchanged-state
faults too. At the Foodcom scale with fewer users, so that a test run
holds it."""

import pytest

from portbench import calibrate, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda_device, cache_dir, monkeypatch):
    from portbench.reference import plain

    monkeypatch.setattr(harness, "CACHE", cache_dir)
    cell = harness.Cell(name)
    cell.config["data"]["params"].update(n_users=1000, neg_num=500)
    for seed in (11, 12, 13):
        ctx = harness.Context(cell, seed, cuda_device)
        data = plain.load_dataset(f"{ctx.data_root}/Foodcom")
        for side, nums in calibrate.control(ctx, data).items():
            if side.startswith(("control", "fault")):
                assert any(nums[k] > lim for k, lim in cell.limits.items()
                           if k in nums), (side, nums)
