"""optim_host_ms.latent: host ms a chart WAE train step inside the program's
``train.optimizer`` span (train/state.py ``AdamW.step``: clip and update;
the stage has no EMA model), the median over the traced steps from the
program's span store."""

from portbench.program_spans import host_ms, ranges

RANGES = ranges("train.optimizer")


def read(run):
    return host_ms(run, "train.step", ["train.optimizer"])
