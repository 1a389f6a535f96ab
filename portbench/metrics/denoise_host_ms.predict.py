"""denoise_host_ms.predict: host ms a batch inside the program's
``diffusion.sample`` span, the median over the traced batches from the
program's span store: the host's enqueue of the denoiser's launches, the
profiler's cost on the host included."""

from portbench.program_spans import host_ms, ranges

RANGES = ranges("diffusion.sample")


def read(run):
    return host_ms(run, "sample", ["diffusion.sample"])
