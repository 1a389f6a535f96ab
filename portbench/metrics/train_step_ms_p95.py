"""train_step_ms_p95: the 95th percentile (linear interpolation) of every
step time in the window; a step's time is the gap between CUDA events
recorded on the stream after consecutive steps, read after the window, so
that no host sync is added (device clock)."""

import numpy as np


def read(run):
    ms = run.window.unit_ms
    return float(np.percentile(ms, 95)) if len(ms) >= 20 else None
