"""bwd_host_ms.step: host ms a train step inside the program's
``train.grad`` span (``torch.autograd.grad`` over the loss), the median over
the traced steps from the program's span store: the calling thread waits
there while the autograd engine issues the backward."""

from portbench.program_spans import host_ms, ranges

RANGES = ranges("train.grad")


def read(run):
    return host_ms(run, "train.step", ["train.grad"])
