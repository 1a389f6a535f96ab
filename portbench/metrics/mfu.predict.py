"""mfu.predict: model FLOPs of a batch (matrix products and attention,
counted from the shapes: roofline.py ``mapset_batch_flops``) over the
seconds a batch takes in the run's untraced window x 989e12, in %. Read in
the traced run: the traced window itself runs slower, since the profiler
slows the host's enqueue."""

from portbench.readers import mfu


def read(run):
    return mfu(run)
