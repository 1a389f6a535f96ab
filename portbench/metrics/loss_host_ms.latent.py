"""loss_host_ms.latent: host ms a chart WAE train step inside the program's
``train.loss`` span, the median over the traced steps from the program's
span store: the forward's and the loss's enqueue, the profiler's cost on
the host included."""

from portbench.program_spans import host_ms, ranges

RANGES = ranges("train.loss")


def read(run):
    return host_ms(run, "train.step", ["train.loss"])
