"""Parity of the port's Gaussian scene code (gsworld_tpu_torch.gs and the
slot transforms of wrapper.gs_env) with the JAX reference on the CPU:
the synthetic scene, the slot layout, the per-env slot transforms and
reposing.  Inputs are made with numpy from a seed and fed to both."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsworld_tpu.envs.agents.base import get_agent as j_get_agent
import gsworld_tpu.envs.agents.fr3_umi  # noqa: F401  (registers agents)
from gsworld_tpu.gs.transform import repose_scene as j_repose
from gsworld_tpu.wrapper.gs_env import GSWorldWrapper
from gsworld_tpu_torch.envs.tasks.tabletop.franka.align import AlignFr3Env
from gsworld_tpu_torch.gs.model import SCENE_FIELDS, scene_from_numpy
from gsworld_tpu_torch.gs.scene_factory import get_scene
from gsworld_tpu_torch.gs.transform import SlotTransforms, repose_scene
from gsworld_tpu_torch.wrapper.gs_env import GSWorldRenderer

SIZES = dict(n_background=1000, n_per_link=60, n_per_object=80)
# f32 rotation chains in another operation order
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """The JAX wrapper (over a stand-in env that carries only what its
    constructor reads) and the port's renderer, same scene config."""
    env = AlignFr3Env(num_envs=3)
    jagent = j_get_agent("fr3_umi")
    fake = types.SimpleNamespace(
        num_envs=3, agent=jagent, robot_uids="fr3_umi",
        scene=types.SimpleNamespace(actors=types.SimpleNamespace(
            names=env.actor_names)),
        actor_index=env.actor_index, cameras=[])
    jw = GSWorldWrapper(fake, "fr3_align", synthetic_sizes=SIZES)
    tw = GSWorldRenderer(env, "fr3_align", synthetic_sizes=SIZES,
                         device="cpu")
    return jw, tw


def _random_poses(B, L, A, seed):
    rng = np.random.default_rng(seed)

    def quats(*shape):
        q = rng.normal(size=shape + (4,))
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32)

    return (rng.normal(size=(B, L, 3)).astype(np.float32) * 0.3,
            quats(B, L),
            rng.normal(size=(B, A, 3)).astype(np.float32) * 0.3,
            quats(B, A),
            rng.uniform(0.8, 1.2, size=(B, A)).astype(np.float32))


class TestScene:
    def test_synthetic_scene_matches_jax(self, pair):
        jw, tw = pair
        for f in SCENE_FIELDS:
            a = np.asarray(getattr(jw.scene, f))
            b = getattr(tw.scene, f).numpy()
            if f == "means":      # f32 FK places the link Gaussians
                np.testing.assert_allclose(b, a, atol=TOL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f)
        assert dataclasses.asdict(tw.layout) == dataclasses.asdict(jw.layout)
        assert tw.gs_objects == jw.gs_objects
        assert tw.scale_sim2real == pytest.approx(jw.scale_sim2real,
                                                  rel=1e-12)

    def test_scene_from_numpy_carries_jax_weights(self, pair):
        jw, _ = pair
        scene = scene_from_numpy({f: np.asarray(getattr(jw.scene, f))
                                  for f in SCENE_FIELDS}, device="cpu")
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                          np.asarray(getattr(jw.scene, f)))

    def test_get_scene_merges_real_scans_or_falls_back(self, tmp_path):
        """A config whose scans exist is merged (is_real); only a missing
        file falls back to the synthetic scene; a broken scan raises."""
        from gsworld_tpu_torch.gs import synthetic
        from gsworld_tpu_torch.gs.ply import save_splats_to_ply
        cfg_dir, asset_dir = tmp_path / "configs", tmp_path / "assets"
        cfg_dir.mkdir()
        ply = asset_dir / "scene" / "robot.ply"
        splats = synthetic.make_blob(np.random.default_rng(0), 50,
                                     [0, 0, 0], 0.1, [0.5, 0.5, 0.5], 3)
        save_splats_to_ply(splats, str(ply))
        (cfg_dir / "fr3_test.json").write_text(json.dumps({"models": [
            {"data_path": "./scene/robot.ply", "semantic_labels": 201}]}))
        model = AlignFr3Env().agent.model
        kw = dict(model=model, scan_qpos=np.zeros(model.dof, np.float32),
                  object_names=[], link_names=list(model.link_names),
                  cfg_dir=str(cfg_dir), asset_dir=str(asset_dir),
                  synthetic_sizes=dict(n_background=10, n_per_link=2,
                                       n_per_object=2), device="cpu")
        scene, _, is_real = get_scene("fr3_test", **kw)
        assert is_real and scene.num_gaussians == 50
        np.testing.assert_array_equal(scene.means.numpy(), splats["means"])
        assert (scene.semantics.numpy() == 201).all()
        ply.write_bytes(b"ply\n")                 # broken: raises
        with pytest.raises(ValueError, match="PLY header"):
            get_scene("fr3_test", **kw)
        ply.unlink()                               # missing: synthetic
        scene, _, is_real = get_scene("fr3_test", **kw)
        assert not is_real and scene.num_gaussians > 0


class TestRepose:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_slots_and_repose_match_jax(self, pair, seed):
        jw, tw = pair
        L = len(tw.env.agent.model.link_names)
        lp, lq, ap, aq, asc = _random_poses(3, L, 3, seed)
        tslots = tw.slot_transforms(*(torch.as_tensor(x)
                                      for x in (lp, lq, ap, aq, asc)))
        tposed = repose_scene(tw.scene, tslots)
        for b in range(3):
            js = jw._slots_single(jnp.asarray(lp[b]), jnp.asarray(lq[b]),
                                  jnp.asarray(ap[b]), jnp.asarray(aq[b]),
                                  jnp.asarray(asc[b]))
            for name in ("R", "t", "scale"):
                np.testing.assert_allclose(
                    getattr(tslots, name)[b].numpy(),
                    np.asarray(getattr(js, name)), atol=TOL, err_msg=name)
            np.testing.assert_array_equal(tslots.apply_scale.numpy(),
                                          np.asarray(js.apply_scale))
            jposed = j_repose(jw.scene, js)
            for name in ("means", "log_scales", "quats", "logit_opacities"):
                np.testing.assert_allclose(
                    getattr(tposed, name)[b].numpy(),
                    np.asarray(getattr(jposed, name)), rtol=TOL, atol=TOL,
                    err_msg=name)

    def test_identity_slots_leave_scene_unchanged(self, pair):
        _, tw = pair
        S = tw.layout.num_slots
        eye = torch.eye(3).repeat(1, S, 1, 1)
        slots = SlotTransforms(
            R=eye, t=torch.zeros(1, S, 3), scale=torch.ones(1, S),
            apply_scale=torch.zeros(S, dtype=torch.bool))
        posed = repose_scene(tw.scene, slots)
        np.testing.assert_allclose(posed.means[0].numpy(),
                                   tw.scene.means.numpy(), atol=1e-6)
        np.testing.assert_allclose(posed.quats[0].numpy(),
                                   tw.scene.quats.numpy(), atol=1e-6)
