"""loss_ms.latent: device ms a chart WAE train step launched inside the
program's ``train.loss`` span (models/latent/train.py ``step_gradients``:
the encoders', the decoder's forward and the latent loss), in the traced
window. The backward's kernels are launched by the autograd engine's
thread, outside any span of the calling thread."""

from portbench.program_spans import device_ms, ranges

RANGES = ranges("train.loss")


def read(run):
    return device_ms(run, "train.step", ["train.loss"])
