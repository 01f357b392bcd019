"""The forward compositor's share (%) of its roofline in the closed
loop's traced window: the least time its work needs on one H100
(``benchmark/roofline.py``) over the profiler's device time of its
kernels (the record gather and the compositor) per call.

The work is counted by the benchmark's own plain walk, under the
configuration's caps, on the reference's projection of the states the
traced steps reached: every frame of the check's sampled envs, scaled by
envs over sampled envs (exact where every env is sampled)."""

from benchmark import roofline



def read(rec):
    d, t = rec.driver, rec.trace
    if t is None or not getattr(d, "traced_states", None):
        return None
    calls, secs = t.matching(("composite_kernel",), exclude=("bwd",))
    secs += t.matching(("pack_records_kernel",))[1]
    if calls == 0 or secs <= 0:
        return None
    from benchmark.reference.closed_loop import projected
    ref = d.reference_loop()
    work = {}
    for state in d.traced_states:
        flat, cfg = projected(ref, state, d.check_envs)
        work = roofline.add_work(work, roofline.count_frames(flat, cfg))
    scale = rec.notes["num_envs"] / len(d.check_envs)
    work = {k: v * scale for k, v in work.items()}
    segment = "segmentation" in d.config["obs_mode"]
    bound_s = roofline.composite_fwd_bound(work, segment)[0]
    # the work of every traced step against the kernels of the same steps
    per_call = secs / calls
    return 100.0 * (bound_s / len(d.traced_states)) / per_call
