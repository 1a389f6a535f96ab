"""k4_roofline.predict: the SwiGLU forward (K4) of the denoiser, where
``nn/blocks.py`` calls ``ops/swiglu.py`` ``swiglu``: the least time of its
calls (roofline.py ``swiglu_fwd_work``, from each call's shapes) over the
device time launched inside them, in %."""

from portbench.readers import roofline_share
from portbench.roofline import swiglu_fwd_work

SPANS = {"swiglu": "osu_dreamer_tpu_torch.nn.blocks:swiglu"}


def work(shapes):
    (B, L, C), (K, _), (H, _) = shapes[0], shapes[1], shapes[5]
    return swiglu_fwd_work(B, L, C, H, K)


def read(run):
    return roofline_share(run, "swiglu", work, "swiglu")
