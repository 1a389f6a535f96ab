"""mfu.latent: model FLOPs of a chart WAE train step (latent_work.py
``latent_train_flops``: the chart encoder, the audio encoder and the
decoder over the 2B window halves, the backward at twice the forward, no
recompute) over the seconds a step takes in the run's untraced window x
989e12, in %."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
