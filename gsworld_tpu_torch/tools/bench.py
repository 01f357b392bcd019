"""The port's benchmark: closed-loop env steps/s with the 640x480
GS render, the rows the repository's root ``bench.py`` prints for the
JAX package, measured through ``gsworld_tpu_torch``.

    python -m gsworld_tpu_torch.tools.bench
    python -m gsworld_tpu_torch.tools.bench --preset smoke --device cpu

Prints one JSON line per row, ``{"metric": "...", "value": N, "unit":
"...", "vs_baseline": N}``, in ``bench.py``'s order: the 1-env row at
``BENCH_EP_LEN`` steps, the 64-env row at 3 steps, then the headline row
at ``BENCH_NUM_ENVS`` envs last.  The two extra rows are skipped under
``BENCH_EXTRA_ROWS=0`` or the smoke preset (``BENCH_PRESET=smoke`` or
``--preset smoke``: 1 env, 3 steps, 160x120, synthetic scale 0.05); a
failed extra row prints a ``#`` line and the headline still runs.

Each row builds AlignFr3Env-v1 and its GS wrapper with
``rollout.random_actions.build`` (fr3_align, sim 120 Hz / control 40 Hz,
the bench raster: tile ``BENCH_TILE`` 32, D ``BENCH_MAX_TILES`` 64, E
``BENCH_ENTRIES`` 393216, obs mode ``BENCH_OBS_MODE``, default
``rgb+segmentation``) and measures it with ``rollout_fps(wrapper,
length, seed=0, use_scan=True, shard=shard)``: the scanned loop, one CUDA
graph replay of the whole step per step, best of 3 reps.  ``BENCH_SHARD=1``
splits the env axis over every card when more than one is visible.
The knobs of the JAX package's XLA path (``BENCH_MAX_PER_TILE``,
``BENCH_TILE_CHUNK``, ``BENCH_BUDGET``, ``BENCH_BATCH_FRAMES``) have no
counterpart here: when one is set, one ``#`` line says so.

Runs on the card; ``--device cpu`` runs the same rows on the CPU, with
the kernels' plain versions, for the tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

# the JAX package's divisor (bench.py: the reference's single-env rate,
# 15 env-steps/s, a representative figure and not a measurement)
REFERENCE_SINGLE_ENV_FPS = 15.0
XLA_KNOBS = ("BENCH_MAX_PER_TILE", "BENCH_TILE_CHUNK", "BENCH_BUDGET",
             "BENCH_BATCH_FRAMES")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=os.environ.get("BENCH_PRESET", ""),
                   help="'smoke': 1 env, 3 steps, 160x120, scale 0.05")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def row(metric_envs: int, fps: float, obs_mode: str) -> dict:
    """One row in bench.py's keys, metric string and rounding."""
    return {
        "metric": f"closed-loop env steps/s, 640x480 GS {obs_mode} render, "
                  f"{metric_envs} envs (AlignFr3Env-v1 random actions)",
        "value": round(fps, 2),
        "unit": "env-steps/s",
        "vs_baseline": round(fps / REFERENCE_SINGLE_ENV_FPS, 2),
    }


def main(argv=None):
    import torch
    from gsworld_tpu_torch.rollout import random_actions

    args = parse_args(argv)
    env_ = os.environ
    num_envs = int(env_.get("BENCH_NUM_ENVS", "4"))
    ep_len = int(env_.get("BENCH_EP_LEN", "10"))
    width = int(env_.get("BENCH_WIDTH", "640"))
    height = int(env_.get("BENCH_HEIGHT", "480"))
    synthetic_scale = float(env_.get("BENCH_SYNTH_SCALE", "1.0"))
    smoke = args.preset == "smoke"
    if smoke:
        num_envs, ep_len, width, height, synthetic_scale = 1, 3, 160, 120, 0.05
    obs_mode = env_.get("BENCH_OBS_MODE", "rgb+segmentation")
    shard = (env_.get("BENCH_SHARD", "0") == "1"
             and torch.cuda.device_count() > 1)
    knobs = [k for k in XLA_KNOBS if k in env_]
    if knobs:
        print(f"# {', '.join(knobs)}: knobs of the JAX package's XLA path, "
              f"with no counterpart in the port; ignored", flush=True)

    def measure(n_envs, length):
        env, wrapper = random_actions.build(
            "AlignFr3Env-v1", n_envs, "fr3_align", 120, 40, width, height,
            synthetic_scale=synthetic_scale, obs_mode=obs_mode,
            max_tiles_per_gaussian=int(env_.get("BENCH_MAX_TILES", "64")),
            tile=int(env_.get("BENCH_TILE", "32")),
            max_entries=int(env_.get("BENCH_ENTRIES", "393216")),
            device=args.device)
        try:
            fps, _, _ = random_actions.rollout_fps(
                wrapper, length, seed=0, use_scan=True, shard=shard)
        finally:
            del env, wrapper
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        return fps

    if env_.get("BENCH_EXTRA_ROWS", "1") == "1" and not smoke:
        for n_extra, len_extra in ((1, ep_len), (64, 3)):
            try:
                print(json.dumps(row(n_extra, measure(n_extra, len_extra),
                                     obs_mode)), flush=True)
            except Exception as e:  # never lose the headline row
                print(f"# extra bench row ({n_extra} envs) failed: {e}",
                      flush=True)

    print(json.dumps(row(num_envs, measure(num_envs, ep_len), obs_mode)),
          flush=True)


if __name__ == "__main__":
    main()
