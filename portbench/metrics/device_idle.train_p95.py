"""device_idle.train_p95: ``device_idle.train`` in a cell whose steps the
host paces, where it moves ``train_step_ms_p95``: 100 x (1 - device busy a
step in the trace / seconds a step of the untraced window), in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
