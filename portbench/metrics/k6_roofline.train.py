"""k6_roofline.train: the SwiGLU backward (K6 and its two products at
width 512): the least time of its calls (roofline.py ``swiglu_bwd_work``,
no recompute, from the forward call's shapes) over the device time
launched inside the autograd engine's range of ``SwiGLUFunctionBackward``,
in %."""

from portbench.readers import roofline_share
from portbench.roofline import swiglu_bwd_work
from portbench.trace import BACKWARD

SPANS = {"swiglu": "osu_dreamer_tpu_torch.nn.blocks:swiglu"}
RANGES = (BACKWARD.format("SwiGLUFunctionBackward"),)


def work(shapes):
    (B, L, C), (K, _), (H, _) = shapes[0], shapes[1], shapes[5]
    return swiglu_bwd_work(B, L, C, H, K)


def read(run):
    return roofline_share(run, "swiglu", work, "swiglu_bwd", backward=RANGES[0])
