"""95th percentile (ms) of every ``GSWorldWrapper.step`` call in the
window, each timed from the call until its observations are ready on the
device, host clock; the tail a policy in the loop waits for."""

import numpy as np


def read(rec):
    if not rec.calls or "env_steps" not in rec.work:
        return None
    return 1e3 * float(np.percentile(np.asarray(rec.calls), 95))
