"""latent_ms.predict: device ms a batch launched inside the program's
``latent.encode`` and ``latent.decode`` spans (``LDM.forward``: the audio
encoder over the songs, the decoder and label head over the rows), in the
traced window."""

from portbench.program_spans import device_ms, ranges

SPANS_READ = ["latent.encode", "latent.decode"]
RANGES = ranges(*SPANS_READ)


def read(run):
    return device_ms(run, "sample", SPANS_READ)
