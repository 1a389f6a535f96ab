"""device_idle.train: 100 x (1 - device busy a step / seconds a step):
busy is the union of the kernel, copy and set intervals of the traced
steps (trace.py), the seconds a step those of the run's untraced window
(the profiler slows the host's enqueue, so the traced window's own idle
share, which the result's ``busy_s`` and ``window_s`` give, reads high), in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
