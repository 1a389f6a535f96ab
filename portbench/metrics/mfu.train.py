"""mfu.train: model FLOPs of a train step (matrix products and attention,
counted from the shapes: roofline.py ``denoiser_train_flops``, the
backward at twice the forward, no recompute) over the seconds a step takes
in the run's untraced window x 989e12, in %. Read in the traced run: the
traced window itself runs slower, since the profiler slows the host's
enqueue."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
