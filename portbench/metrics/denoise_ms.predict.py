"""denoise_ms.predict: device ms a batch launched inside the program's
``diffusion.sample`` span (models/inference/model.py ``LDM.forward``: the
denoiser's 33 predictions and the sampler's arithmetic between them), in
the traced window."""

from portbench.program_spans import device_ms, ranges

RANGES = ranges("diffusion.sample")


def read(run):
    return device_ms(run, "sample", ["diffusion.sample"])
