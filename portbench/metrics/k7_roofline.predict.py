"""k7_roofline.predict: the attention forward past the fused gate (K7 at
latent length 759), where ``nn/attention.py`` calls
``ops/long_attention.py`` ``long_flash_attention``: the least time of its
calls (roofline.py ``attention_fwd_work``) over the device time launched
inside them, in %."""

from portbench.readers import roofline_share
from portbench.roofline import attention_fwd_work

SPANS = {"attention_long": "osu_dreamer_tpu_torch.nn.attention:long_flash_attention"}


def work(shapes):
    B, L, H, D = shapes[0]
    return attention_fwd_work(B, L, H, D)


def read(run):
    return roofline_share(run, "attention_long", work, "flash_attention")
