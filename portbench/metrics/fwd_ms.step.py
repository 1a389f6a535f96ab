"""fwd_ms.step: device ms a train step launched inside the program's
``train.loss`` span (models/diffusion/train.py ``step_gradients``: the
denoiser's forward and the loss), in the traced window. The backward's
kernels are launched by the autograd engine's thread, outside any span of
the calling thread."""

from portbench.program_spans import device_ms, ranges

RANGES = ranges("train.loss")


def read(run):
    return device_ms(run, "train.step", ["train.loss"])
