"""k2_roofline.latent: ``k2_roofline.predict`` in the chart WAE's train step:
the film layer forward (K2) of its 11 FiLM stacks, where ``nn/blocks.py``
``FilmStack`` calls ``ops/film_layer.py`` ``film_layer``: the least time of
its calls (roofline.py ``film_layer_fwd_work``) over the device time
launched inside them, in %."""

from portbench.readers import roofline_share
from portbench.roofline import film_layer_fwd_work

SPANS = {"film_layer": "osu_dreamer_tpu_torch.nn.blocks:film_layer"}


def work(shapes):
    (B, L, C), (K, _), (H, _) = shapes[0], shapes[6], shapes[10]
    return film_layer_fwd_work(B, L, C, H, K)


def read(run):
    return roofline_share(run, "film_layer", work, "film_layer")
