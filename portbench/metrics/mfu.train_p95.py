"""mfu.train_p95: ``mfu.train`` in a cell whose steps the host paces, where
it moves ``train_step_ms_p95``: model FLOPs of a train step (roofline.py
``denoiser_train_flops``, the backward at twice the forward, no recompute)
over the seconds a step takes in the run's untraced window x 989e12, in %."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
