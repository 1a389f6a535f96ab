"""opt_host_ms.step: host ms a train step inside the program's
``train.optimizer`` and ``train.ema`` spans (train/state.py ``AdamW.step``,
clip and update, and ``ema_update``), the median over the traced steps from
the program's span store."""

from portbench.program_spans import host_ms, ranges

SPANS_READ = ["train.optimizer", "train.ema"]
RANGES = ranges(*SPANS_READ)


def read(run):
    return host_ms(run, "train.step", SPANS_READ)
