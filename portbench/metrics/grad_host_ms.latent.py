"""grad_host_ms.latent: host ms a chart WAE train step inside the program's
``train.grad`` span (``torch.autograd.grad`` over the normalised loss), the
median over the traced steps from the program's span store: the calling
thread waits there while the autograd engine issues the backward."""

from portbench.program_spans import host_ms, ranges

RANGES = ranges("train.grad")


def read(run):
    return host_ms(run, "train.step", ["train.grad"])
