"""k10_roofline.train_p95: the fused norm + RoPE attention backward (K10): the
least time of its calls (roofline.py ``attention_bwd_work``, packed, no
recompute, from the forward call's shapes) over the device time launched
inside the autograd engine's range of ``FusedNormRopeAttentionBackward``,
in %."""

from portbench.readers import roofline_share
from portbench.roofline import attention_bwd_work
from portbench.trace import BACKWARD

SPANS = {"attention_fused": "osu_dreamer_tpu_torch.nn.attention:fused_norm_rope_attention"}
RANGES = (BACKWARD.format("FusedNormRopeAttentionBackward"),)


def work(shapes):
    (B, L, three_hd), (D,), H = shapes[0], shapes[1], shapes[3]
    return attention_bwd_work(B, L, H, D, packed=True)


def read(run):
    return roofline_share(run, "attention_fused", work, "fused_attention_bwd",
                          backward=RANGES[0])
