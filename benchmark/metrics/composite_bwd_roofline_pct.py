"""The backward compositor's share (%) of its roofline in the training
cell's traced window: the least time its work needs on one H100
(``benchmark/roofline.py``) over the profiler's device time of its
kernel per call.

The work is counted by the benchmark's own plain walk, under the
configuration's caps, on the reference's projection of the Gaussians the
traced window ended with, from the camera of each traced iteration."""

from types import SimpleNamespace

from benchmark import roofline


def read(rec):
    d, t = rec.driver, rec.trace
    if t is None or not getattr(d, "traced_cams", None) \
            or getattr(d, "traced_scene", None) is None:
        return None
    calls, secs = t.matching(("composite_bwd_kernel",))
    if calls == 0 or secs <= 0:
        return None
    from benchmark.reference.train_3dgs import projected
    scene = SimpleNamespace(**{f: v.to(d.device)
                               for f, v in d.traced_scene.items()})
    work = {}
    for ci in sorted(set(d.traced_cams)):
        flat, cfg = projected(d.inputs, scene, ci)
        w = roofline.count_frames(flat, cfg)
        n = d.traced_cams.count(ci)
        work = roofline.add_work(work, {k: v * n for k, v in w.items()})
    bound_s = roofline.composite_bwd_bound(work)[0] / len(d.traced_cams)
    return 100.0 * bound_s / (secs / calls)
