"""The check catches a broken timed path.  A run of each cell, at a
size the CPU holds and with the card check skipped, is driven with the
program broken underneath, and ``correct`` comes out false for each
fault the cell can have: a step that returns its state unchanged, half
of the batch left out (the closed loop: half of the envs not stepped;
training: the loss taken over half of the image, its mean over the
rest), an answer altered where it is produced (the compositor's image).
(A one-card cell has no exchange between cards to leave out.)  An
unbroken run comes out correct."""

import dataclasses
import time

import pytest

from benchmark import faults
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell, tiny_train_cell

SEED = 2 ** 31 + 101


def run(num_envs=2):
    cell = tiny_cell("fr3_align_loop.e64", num_envs=num_envs, envs=num_envs)
    result, checks = run_cell(cell, SEED, 1.0, False, device="cpu",
                              t0=time.perf_counter())
    return result, {name: (value, limit) for name, value, limit in checks}


def keep_half(new, old):
    """``new`` with its second half of envs replaced by ``old``'s."""
    def mix(a, b):
        if a is None:
            return None
        out = a.clone()
        h = a.shape[0] // 2
        out[h:] = b[h:]
        return out
    world = dataclasses.replace(new.world, **{
        f.name: mix(getattr(new.world, f.name), getattr(old.world, f.name))
        for f in dataclasses.fields(new.world)})
    return dataclasses.replace(
        new, world=world, elapsed=mix(new.elapsed, old.elapsed),
        prev_target=mix(new.prev_target, old.prev_target),
        task={k: mix(v, old.task[k]) for k, v in new.task.items()})


def test_unbroken_run_is_correct():
    result, checks = run()
    assert result["correct"], checks


def test_step_returning_its_state_unchanged(monkeypatch):
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
    step = GSWorldWrapper._step_and_render

    def broken(self, state, action):
        out = step(self, state, action)
        return (state,) + tuple(out[1:])

    monkeypatch.setattr(GSWorldWrapper, "_step_and_render", broken)
    result, checks = run()
    assert not result["correct"]
    assert checks["state_gap"][0] > checks["state_gap"][1]


def test_half_the_envs_left_out(monkeypatch):
    from gsworld_tpu_torch.wrapper.gs_env import GSWorldWrapper
    step = GSWorldWrapper._step_and_render

    def broken(self, state, action):
        out = step(self, state, action)
        return (keep_half(out[0], state),) + tuple(out[1:])

    monkeypatch.setattr(GSWorldWrapper, "_step_and_render", broken)
    result, checks = run()
    assert not result["correct"]
    assert checks["state_gap"][0] > checks["state_gap"][1]


def test_image_altered_where_produced():
    with faults.altered_image():
        result, checks = run()
    assert not result["correct"]
    assert checks["rgb_mae"][0] > checks["rgb_mae"][1]


def run_train():
    result, checks = run_cell(tiny_train_cell(), SEED, 1.0, False,
                              device="cpu", t0=time.perf_counter())
    return result, {name: (value, limit) for name, value, limit in checks}


def failing(checks):
    return [k for k, (value, limit) in checks.items() if not value <= limit]


def test_training_unbroken_run_is_correct():
    result, checks = run_train()
    assert result["correct"], checks


def test_training_step_returning_its_state_unchanged(monkeypatch):
    """Adam's update left out: the state comes back as it went in."""
    from gsworld_tpu_torch.train3dgs import train
    monkeypatch.setattr(train, "adam_update", lambda *a, **k: None)
    result, checks = run_train()
    assert not result["correct"] and "change_gap" in failing(checks)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_training_fault(fault):
    with faults.FAULTS[fault]():
        result, checks = run_train()
    assert not result["correct"], checks


def _no_reset(scene, *args, **kwargs):
    return scene


def _no_densify(scene, ds, *args, **kwargs):
    import torch
    return scene, ds, torch.zeros_like(ds.alive)


@pytest.mark.parametrize("name,fault", [("reset_opacity", _no_reset),
                                        ("densify_and_prune", _no_densify)])
def test_training_late_stretch_fault(monkeypatch, name, fault):
    """The opacity reset, or the densify pass, left out of ``train``'s
    loop: the late stretch catches it."""
    from gsworld_tpu_torch.train3dgs import train
    monkeypatch.setattr(train, name, fault)
    result, checks = run_train()
    assert not result["correct"], checks
    assert set(failing(checks)) & {"late_change_gap", "late_alive_flips",
                                   "late_loss_gap"}, checks
