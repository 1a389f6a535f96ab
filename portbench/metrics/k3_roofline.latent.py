"""k3_roofline.latent: the film layer's backward (K3 and the torch around it)
in the chart WAE's train step, where ``nn/blocks.py`` ``FilmStack`` calls
``ops/film_layer.py`` ``film_layer``: the least time of its calls
(latent_work.py ``film_layer_bwd_work``, from the forward call's shapes)
over the device time launched inside the autograd engine's range of
``FilmLayerFunctionBackward``, in %."""

from portbench.latent_work import film_layer_bwd_work
from portbench.readers import roofline_share
from portbench.trace import BACKWARD

SPANS = {"film_layer": "osu_dreamer_tpu_torch.nn.blocks:film_layer"}
RANGES = (BACKWARD.format("FilmLayerFunctionBackward"),)


def work(shapes):
    (B, L, C), (K, _), (H, _) = shapes[0], shapes[6], shapes[10]
    return film_layer_bwd_work(B, L, C, H, K)


def read(run):
    return roofline_share(run, "film_layer", work, "film_layer_bwd", backward=RANGES[0])
