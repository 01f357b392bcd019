"""Shared helpers of the tests/test_torch_*.py files that hold the port's
physics, env and closed loop against the JAX package: numpy bridges in
both directions, hand-made AlignFr3 layouts, and comparisons relative to
each field's largest value."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsworld_tpu.physics.world import WorldState as JWorldState
from gsworld_tpu_torch import constants
from gsworld_tpu_torch.physics.world import WORLD_FIELDS, world_state_from_numpy



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's physics on the CPU is thousands of tiny operations that
    gain nothing from intra-op threads; one thread per test process keeps
    parallel test workers from oversubscribing the cores.  Restored after
    the module.  A test module takes it by importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


X_OFFSET = 0.615
UPRIGHT = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0], np.float32)
RACK_Q = np.array([np.cos(np.pi / 4), 0, 0, -np.sin(np.pi / 4)], np.float32)


def jax_world_to_numpy(w):
    """Batched JAX WorldState -> dict of numpy arrays, field by field."""
    return {f: np.asarray(getattr(w, f)) for f in WORLD_FIELDS}


def numpy_to_jax_world(d):
    return JWorldState(**{f: jnp.asarray(d[f]) for f in WORLD_FIELDS})


def torch_world(d):
    return world_state_from_numpy(d, device="cpu")


def rel_err(got, want, floor=1e-12):
    """max |got - want| / max(max |want|, floor), on numpy arrays.  The
    floor is the scale below which a field is noise around zero (the
    velocity of a body at rest)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def blank_world(B, n_rows, n_la, rng=None):
    """A world of B envs at the task-init pose: both cans upright at rest
    on the table, the rack in its goal range; everything else zero."""
    q = np.tile(np.asarray(constants.fr3_umi_task_init_qpos, np.float32),
                (B, 1))
    a_pos = np.tile(np.array([[X_OFFSET - 0.18, 0.15, 0.065],
                              [X_OFFSET - 0.05, 0.12, 0.05],
                              [X_OFFSET - 0.15, -0.15, 0.068]], np.float32),
                    (B, 1, 1))
    if rng is not None:
        a_pos[:, :, :2] += rng.uniform(-0.01, 0.01, (B, 3, 2))
    a_quat = np.tile(np.stack([UPRIGHT, UPRIGHT, RACK_Q]), (B, 1, 1))
    z = lambda *s: np.zeros(s, np.float32)                    # noqa: E731
    root_quat = z(B, 4)
    root_quat[:, 0] = 1.0
    return dict(qpos=q, qvel=z(B, 9), root_pos=z(B, 3), root_quat=root_quat,
                a_pos=a_pos.astype(np.float32), a_quat=a_quat,
                a_lin=z(B, 3, 3), a_ang=z(B, 3, 3), la_forces=z(B, n_la, 3),
                contact_lam=z(B, n_rows, 6),
                a_friction=np.full((B, 3), 0.6, np.float32),
                a_scale=np.ones((B, 3), np.float32))


def pinched_world(B, n_rows, n_la, tcp_pos, finger_q=0.0325):
    """The green can between the fingers, 3.5 cm below the TCP, with the
    fingers closed onto its radius of 3.3 cm (0.5 mm of penetration each
    side); ``tcp_pos`` (3,) is the TCP position at the task-init pose."""
    d = blank_world(B, n_rows, n_la)
    d["qpos"][:, 7:] = finger_q
    d["a_pos"][:, 0] = np.asarray(tcp_pos, np.float32) - np.array(
        [0.0, 0.0, 0.035], np.float32)
    return d


def lifted_world(B, n_rows, n_la):
    """Everything apart: cans and rack 30 cm above the table."""
    d = blank_world(B, n_rows, n_la)
    d["a_pos"][:, :, 2] += 0.3
    return d


def jit_vmap(fn):
    return jax.jit(jax.vmap(fn))
