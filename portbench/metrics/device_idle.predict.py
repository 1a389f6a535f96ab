"""device_idle.predict: 100 x (1 - device busy a batch / seconds a batch):
busy is the union of the kernel, copy and set intervals of the traced
batches (trace.py), the seconds a batch those of the run's untraced window
(the profiler slows the host's enqueue, so the traced window's own idle
share, which the result's ``busy_s`` and ``window_s`` give, reads high), in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
