"""The render alone (ms): replays of the renderer's render graph
(``GSWorldRenderer.render`` of the sensor cameras: FK, repose,
projection, binning, the compositor, RGB and segmentation) at the state
the traced window reached, between two CUDA events."""

from benchmark.timing import cuda_ms

REPS = 10


def read(rec):
    d = rec.driver
    wrapper = getattr(d, "wrapper", None)
    if rec.trace is None or wrapper is None \
            or wrapper.env.device.type != "cuda":
        return None
    from gsworld_tpu_torch.wrapper.gs_env import world_poses
    st = wrapper.env._state
    poses = world_poses(st.world, st.task)
    return cuda_ms(lambda: wrapper.renderer.render(poses), REPS, warmup=1)
