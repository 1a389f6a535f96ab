"""qk_prep_roofline.predict: the long attention route's q/k norm and RoPE
at latent length 759, where ``nn/attention.py`` calls ``ops/norm_rope.py``
``norm_rope_qkv``: the least time of its calls over the device time launched
inside them, in %. A call's work is bytes alone: q and k read from the
packed rows and written once each in bf16 (4 B L H D elements), the two
(L, D/2) bf16 rotary tables and the two (D,) bf16 gains. v's copy is left
out, so a pass that reads v where it lies cannot read past 100 %.

A program without that entry gets no span (the wrapper would have nothing
to wrap) and reads None."""

import importlib

from portbench.readers import roofline_share
from portbench.roofline import BF16

MODULE, ENTRY = "osu_dreamer_tpu_torch.nn.attention", "norm_rope_qkv"


def __getattr__(name):
    """``SPANS``, asked for when the traced part is set up: the entry's span
    where the program has the entry, else none"""
    if name != "SPANS":
        raise AttributeError(name)
    try:
        has = hasattr(importlib.import_module(MODULE), ENTRY)
    except ImportError:
        has = False
    return {"qk_prep": f"{MODULE}:{ENTRY}"} if has else {}


def work(shapes):
    (B, L, three_hd), H = shapes[0], shapes[3]
    D = three_hd // (3 * H)
    return 0.0, BF16 * (4 * B * L * H * D + 2 * L * (D // 2) + 2 * D)


def read(run):
    return roofline_share(run, "qk_prep", work, "qk_prep")
