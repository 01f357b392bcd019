"""The control comes out not correct: the reference put in the program's
place one precision step below the configuration's float32 (the loop's
with TF32 products, training's with bfloat16 leaves and targets) fails a
limit of the cell's check on every seed, while the program passes all
of them.  On the card only, at a size a test run holds (the cell's own
size: ``python3 -m benchmark.control``)."""

import pytest

from benchmark import harness as H
from benchmark.tests.tiny import tiny_cell


@pytest.mark.card
def test_control_fails_and_program_passes(card):
    cell = tiny_cell("fr3_align_loop.e64", num_envs=4, envs=2, steps=2)
    driver = H.driver_module("closed_loop").Driver(cell, 11, device="cuda")
    driver.setup()
    limits = cell.traffic["check"]["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out = driver.read_seed(seed, 1.0, True)
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control"][k] > v for k, v in limits.items()), out


@pytest.mark.card
def test_training_control_fails_and_program_passes(card):
    from benchmark.tests.tiny import tiny_train_cell
    cell = tiny_train_cell()
    driver = H.driver_module("train_3dgs").Driver(cell, 11, device="cuda")
    driver.setup()
    limits = cell.traffic["check"]["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out = driver.read_seed(seed, 1.0, True)
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control"][k] > v for k, v in limits.items()), out
