"""The contact solver's normal Newton kernel (csrc/contact_newton.cu,
through ``physics/world.py:normal_newton``) on the card, against its plain
version on the card and against a float64 run of the plain version on the
CPU, on the systems of states reached by seeded steps: the FR3 align loop
at 64 envs and at 1 env (180 rows), the xArm's domain-randomized loop at
64 envs (108 rows) and SpoonOnBoardXArmEnv-v1 at 4 envs (264 rows: the
matrix waits in device memory, not beside the factor).

At the benchmark's batched shapes (64 envs, 108 and 180 rows) the kernel
takes every sum in the batched library routines' order, so it gives the
plain version's bits.  Elsewhere (one env, whose plain version takes
other routines; 264 rows) it agrees to float32 rounding: the systems of
resting and grasped objects hold redundant contacts, whose impulses
float32 moves within the matrix's near-null space (the plain version
lies up to ~6e-4 of the largest impulse from its float64 run), so there
the kernel's distance from float64 is held to F64_RATIO times the plain
version's (or X_TOL, whichever is larger); at one env also the
velocities w = An x + rhs to W_TOL of the largest |rhs| and the rows
that push (x > 0) to the plain version's but where x and w tie within
TIE.  (SpoonOnBoard's matrix reaches ~5e18, a body of near-zero inertia,
where neither float32 path resolves w: only its impulses are held.)
Two calls, and a strided and a contiguous matrix, give the same bits, as
do the two places of the matrix (shared memory, device memory); the
env's step graph replays its eager step bit for bit over 10 steps; one
kernel per substep of a replay by the profiler, none in training; the
wrapper refuses what the kernel does not take.  The module skips without
a CUDA card; the card's machine has no JAX, so it runs without the
tests' conftest:

    python -m pytest tests/test_torch_newton_card.py --noconftest -s
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gsworld_tpu_torch import envs
from gsworld_tpu_torch.physics import world as W
from gsworld_tpu_torch.render.camera import RasterConfig, make_camera
from gsworld_tpu_torch.tools import solve_times
from gsworld_tpu_torch.utils import kernels

SEED = 2 ** 31 + 1919
STEPS = 3         # seeded steps before the one whose systems are taken
X_TOL = 1e-4      # of max |x|, per env: the floor of the float64 gap
F64_RATIO = 3.0   # the kernel's float64 gap over the plain version's
W_TOL = 1e-6      # |w - w_plain| over max |rhs|, per env
TIE = 1e-6        # |x - w| under which a row may push on one side only
KERNEL = chip_smoke.KERNEL_NAMES["normal_newton"]
# env id, envs, env kwargs, rows, what is held: the plain version's bits,
# or float32 agreement with (True) or without (False) the velocities
CASES = {"e64": ("AlignFr3Env-v1", 64, {}, 180, "bits"),
         "dr64": ("AlignXArmEnv-v1", 64, dict(domain_randomization=True),
                  108, "bits"),
         "e1": ("AlignFr3Env-v1", 1, {}, 180, True),
         "spoon_on_board": ("SpoonOnBoardXArmEnv-v1", 4, {}, 264, False)}

pytestmark = [pytest.mark.card, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA card: the CUDA kernels run there only")]


def _actions(env, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [2 * torch.rand((env.num_envs, env.action_dim), generator=gen) - 1
            for _ in range(n)]


def systems(env_id, B, kw):
    """The inputs of every ``normal_newton`` call of one eager control
    step (one per substep) after STEPS seeded steps from reset(SEED)."""
    return solve_times.seeded_systems(env_id, B, SEED, steps=STEPS, **kw)


def velocities(An, rhs, x):
    """w = An x + rhs in float64."""
    return (An.double() @ x.double()[..., None])[..., 0] + rhs.double()


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_and_float64(case):
    env_id, B, kw, rows, held = CASES[case]
    lines, bad = [], []
    for k, (An, act_mask, rhs, x_init) in enumerate(systems(env_id, B, kw)):
        assert An.shape == (B, rows, rows)
        args = (An, act_mask, rhs, x_init)
        kernels.reset_launch_counts()
        got = W.normal_newton(*args)
        assert kernels.launch_counts["normal_newton"] == 1
        again = W.normal_newton(*args)
        # the matrix as the solver hands it: a strided view of W
        wide = torch.zeros((B, rows, 3, rows, 3), device="cuda")
        wide[:, :, 0, :, 0] = An
        strided = W.normal_newton(wide[:, :, 0, :, 0], act_mask, rhs,
                                  x_init)
        plain = W.normal_newton_reference(*args)
        f64 = W.normal_newton_reference(*(
            t.cpu().double() if t.is_floating_point() else t.cpu()
            for t in args))
        torch.cuda.synchronize()
        assert torch.equal(got, again), "two calls differ"
        assert torch.equal(got, strided), "strided and contiguous differ"
        assert bool(torch.isfinite(got).all())
        got, plain = got.cpu(), plain.cpu()
        scale = plain.abs().amax(-1).clamp_min(1e-30)
        e_kp = (got - plain).abs().amax(-1) / scale
        e_k64 = (got.double() - f64).abs().amax(-1) / scale
        e_p64 = (plain.double() - f64).abs().amax(-1) / scale
        # the velocities the impulses leave, over the largest of rhs
        w_k = velocities(An.cpu(), rhs.cpu(), got)
        w_p = velocities(An.cpu(), rhs.cpu(), plain)
        e_w = float(((w_k - w_p).abs().amax(-1)
                     / rhs.cpu().abs().amax(-1).clamp_min(1e-30)).max())
        # the rows that push: the plain version's, but at ties
        flips = (got > 0) != (plain > 0)
        untied = int((flips & ((plain.double() - w_p).abs() > TIE)).sum())
        bound = F64_RATIO * max(X_TOL, float(e_p64.max()))
        act = act_mask.sum(-1)
        lines.append(
            f"{case} substep {k}: {B} envs x {rows} rows, {int(act.min())}-"
            f"{int(act.max())} rows in the mask, {int((plain > 0).sum())} "
            f"pushing; max |x| {float(plain.abs().max()):.4g}; per env max "
            f"kernel vs plain {float(e_kp.max()):.3g}, kernel vs f64 "
            f"{float(e_k64.max()):.3g} (<= {bound:.3g}), plain vs f64 "
            f"{float(e_p64.max()):.3g}; w gap {e_w:.3g}; {int(flips.sum())} "
            f"rows push on one side only, {untied} untied")
        if held == "bits":
            if not torch.equal(got, plain):
                bad.append(lines[-1] + "; not the plain version's bits")
        elif float(e_k64.max()) > bound or (held and (e_w > W_TOL
                                                      or untied)):
            bad.append(lines[-1])
    print("\n  ".join([""] + lines))
    assert not bad, bad


def test_device_memory_layout_gives_the_shared_layout_bits():
    """The e64 systems with An's triangle in device memory (the layout
    above gsw_normal_newton_max_rows(1) rows) against the wrapper's
    shared-memory launch: the same arithmetic, the same bits."""
    An, act_mask, rhs, x_init = systems(*CASES["e64"][:3])[0]
    B, n = rhs.shape
    assert n <= W.normal_newton_limits(An.device)[0]
    want = W.normal_newton(An, act_mask, rhs, x_init)
    lib = kernels.build_kernels()
    out = torch.empty_like(want)
    scratch = torch.empty((B, n * n), device="cuda")
    code = lib.gsw_normal_newton(
        An.data_ptr(), *An.stride(), act_mask.data_ptr(), rhs.data_ptr(),
        x_init.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, n,
        W.NEWTON_ITERS, W.NEWTON_REFINES,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, code, "normal_newton")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_step_graph_replays_eager_bit_for_bit():
    """10 steps of the FR3 env at 4 envs through its step graph against
    ``graph=False``: everything the step returns and the state."""
    chip_smoke.env_graph_vs_eager(4, "normal_newton: env step")


def test_one_launch_per_substep_of_a_step_graph_replay():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    env = envs.make("AlignFr3Env-v1", num_envs=4, device="cuda", graph=True)
    env.reset(seed=SEED)
    acts = _actions(env, 6, SEED + 1)
    for a in acts[:3]:          # warm-up and capture
        env.step(a)
    torch.cuda.synchronize()
    assert "step" in env._graphs
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in acts[3:]:
            env.step(a)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and KERNEL in e.key)
    print(f"3 step-graph replays ({env.scene.substeps} substeps each) ran "
          f"{n} {KERNEL}")
    assert kernels.launch_counts["normal_newton"] == 0   # replays, not launches
    assert n == 3 * env.scene.substeps


def test_training_launches_no_newton_kernel():
    from gsworld_tpu_torch.real2sim.pipeline import train_from_colmap_model
    rng = np.random.default_rng(SEED % 2 ** 32)
    pts = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    cams = []
    for z in (2.0, 2.5):
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = z
        cams.append(make_camera(torch.as_tensor(w2c, device="cuda"), 0.5,
                                0.5))
    imgs = [rng.uniform(0, 1, (48, 64, 3)).astype(np.float32) for _ in cams]
    kernels.reset_launch_counts()
    train_from_colmap_model(pts, cols, cams, imgs,
                            RasterConfig(width=64, height=48), iterations=3,
                            device="cuda", graph=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_bwd"] > 0
    assert kernels.launch_counts["normal_newton"] == 0


def test_refused_inputs_raise():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = 12
    J = torch.randn((2, n, n), generator=gen, device="cuda")
    An = J @ J.transpose(-1, -2) + torch.eye(n, device="cuda")
    act_mask = torch.ones((2, n), dtype=torch.bool, device="cuda")
    rhs = -torch.ones((2, n), device="cuda")
    x0 = torch.zeros((2, n), device="cuda")
    with pytest.raises(TypeError, match="float32"):
        W.normal_newton(An.double(), act_mask, rhs, x0)
    with pytest.raises(TypeError, match="bool"):
        W.normal_newton(An, act_mask.float(), rhs, x0)
    with pytest.raises(ValueError, match="shape"):
        W.normal_newton(An, act_mask, rhs[:, :-1], x0)
    with pytest.raises(ValueError, match="shape"):
        W.normal_newton(An[:, :-1], act_mask, rhs, x0)
    with pytest.raises(ValueError, match="on cpu"):
        W.normal_newton(An, act_mask, rhs.cpu(), x0)
    in_shared, most = W.normal_newton_limits(An.device)
    assert 264 < most and 180 < in_shared <= most
    big = most + 1
    with pytest.raises(ValueError, match=f"up to {most} rows"):
        W.normal_newton(torch.eye(big, device="cuda")[None],
                        torch.ones((1, big), dtype=torch.bool, device="cuda"),
                        -torch.ones((1, big), device="cuda"),
                        torch.zeros((1, big), device="cuda"))
