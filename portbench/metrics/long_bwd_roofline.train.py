"""long_bwd_roofline.train: the long attention backward (past the fused
gate): the least time of its calls (roofline.py ``attention_bwd_work``, no
recompute, from the forward call's shapes) over the device time launched
inside the autograd engine's range of ``LongFlashAttentionBackward``, in %."""

from portbench.readers import roofline_share
from portbench.roofline import attention_bwd_work
from portbench.trace import BACKWARD

SPANS = {"attention_long": "osu_dreamer_tpu_torch.nn.attention:long_flash_attention"}
RANGES = (BACKWARD.format("LongFlashAttentionBackward"),)


def work(shapes):
    B, L, H, D = shapes[0]
    return attention_bwd_work(B, L, H, D, packed=False)


def read(run):
    return roofline_share(run, "attention_long", work, "long_attention_bwd",
                          backward=RANGES[0])
