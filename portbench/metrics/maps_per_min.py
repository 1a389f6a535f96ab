"""maps_per_min: maps (difficulty rows) whose quantized chart reached host
memory and was dequantized, over the window in minutes. The window runs
from its start to the completion of the last batch it issued: every batch
issued is finished and counted (host clock)."""


def read(run):
    w = run.window
    return 60.0 * w.items / w.seconds if w.units else None
