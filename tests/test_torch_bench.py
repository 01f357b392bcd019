"""The port's bench (gsworld_tpu_torch/tools/bench.py) against the root
``bench.py`` of the JAX package, on the CPU:

  (a) both, given the same stand-ins for ``build`` and ``rollout_fps``
      (a fixed rate per env count and episode length), print the same
      lines in the same order for the defaults, BENCH_EXTRA_ROWS=0, the
      smoke preset, BENCH_OBS_MODE=rgb and a failing extra row; a knob of
      the XLA path adds one ``#`` line to the port's output and changes
      nothing else;
  (b) the port's bench at the smoke preset on the CPU for real, in a
      process where ``import jax`` fails: one row, a finite rate > 0,
      bench.py's ``vs_baseline``.

No JAX step compiles: the stand-ins replace the loop in both.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fakes(calls):
    """(build, rollout_fps) stand-ins: the wrapper is its env count, the
    rate depends on it and on the episode length; an env count of 64
    fails when BENCH_TEST_FAIL64 is set."""

    def build(env_id, num_envs, cfg_name, sim_freq, control_freq, width,
              height, **kw):
        calls.append((env_id, num_envs, cfg_name, sim_freq, control_freq,
                      width, height, kw["synthetic_scale"], kw["obs_mode"],
                      kw["tile"], kw["max_tiles_per_gaussian"],
                      kw["max_entries"]))
        if num_envs == 64 and os.environ.get("BENCH_TEST_FAIL64"):
            raise RuntimeError("out of memory (stand-in)")
        return None, num_envs

    def rollout_fps(wrapper, ep_len, seed=0, use_scan=False, shard=False):
        assert seed == 0 and use_scan and not shard
        return 37.0 * wrapper + 1.0 / (ep_len + 2), None, None

    return build, rollout_fps


def _clear_bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)


CASES = {"defaults": {}, "no_extra_rows": {"BENCH_EXTRA_ROWS": "0"},
         "smoke": {"BENCH_PRESET": "smoke"}, "rgb": {"BENCH_OBS_MODE": "rgb"},
         "failed_extra_row": {"BENCH_TEST_FAIL64": "1"}}


def _run_both(monkeypatch, capsys, env):
    """The lines and build calls of the root bench.py and of the port's
    bench under the BENCH_* variables ``env``."""
    import jax
    import gsworld_tpu.rollout.random_actions as jra
    import gsworld_tpu_torch.rollout.random_actions as tra
    from gsworld_tpu_torch.tools import bench

    _clear_bench_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    # the JAX bench points JAX's compilation cache at a directory: leave
    # this process's configuration as it is
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    out = {}
    for name, mod, run in (("jax", jra, lambda: _root_bench().main()),
                           ("port", tra, lambda: bench.main([]))):
        calls = []
        build, fps = _fakes(calls)
        monkeypatch.setattr(mod, "build", build)
        monkeypatch.setattr(mod, "rollout_fps", fps)
        capsys.readouterr()
        run()
        out[name] = (capsys.readouterr().out.splitlines(), calls)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_port_bench_prints_bench_py_lines(monkeypatch, capsys, case):
    """(a) Same lines, same order, same build arguments (the JAX build's
    XLA-path arguments aside)."""
    out = _run_both(monkeypatch, capsys, CASES[case])
    (jl, jcalls), (pl, pcalls) = out["jax"], out["port"]
    assert pl == jl
    assert pcalls == jcalls
    want = {"defaults": 3, "no_extra_rows": 1, "smoke": 1, "rgb": 3,
            "failed_extra_row": 3}[case]
    assert len(pl) == want
    rows = [json.loads(x) for x in pl if not x.startswith("#")]
    assert rows[-1]["metric"].endswith(
        f"{1 if case == 'smoke' else 4} envs (AlignFr3Env-v1 random "
        f"actions)")
    if case == "failed_extra_row":
        assert pl[1].startswith("# extra bench row (64 envs) failed")


def test_xla_knob_prints_one_line(monkeypatch, capsys):
    """(a) BENCH_TILE_CHUNK and BENCH_BUDGET have no counterpart: the port
    prints one ``#`` line naming them, then bench.py's lines."""
    out = _run_both(monkeypatch, capsys, {"BENCH_TILE_CHUNK": "8",
                                          "BENCH_BUDGET": "0.5"})
    (jl, _), (pl, _) = out["jax"], out["port"]
    assert pl[0].startswith("# BENCH_TILE_CHUNK, BENCH_BUDGET:")
    assert pl[1:] == jl


def test_smoke_preset_runs_on_cpu_without_jax():
    """(b) The smoke preset for real on the CPU (1 env, 3 steps, 160x120,
    synthetic scale 0.05, the scanned loop's eager CPU form) with JAX
    unimportable: one row with a finite rate > 0 and vs_baseline =
    round(rate / 15, 2)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "from gsworld_tpu_torch.tools import bench; "
            "bench.main(['--preset', 'smoke', '--device', 'cpu'])")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert list(row) == ["metric", "value", "unit", "vs_baseline"]
    assert row["metric"] == ("closed-loop env steps/s, 640x480 GS "
                             "rgb+segmentation render, 1 envs "
                             "(AlignFr3Env-v1 random actions)")
    assert math.isfinite(row["value"]) and row["value"] > 0
    assert row["vs_baseline"] == round(row["value"] / 15.0, 2)
    assert row["unit"] == "env-steps/s"
