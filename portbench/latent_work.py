"""Operations and bytes of the chart WAE's training step, counted from its
shapes with roofline.py's conventions (two operations a multiply-add; each
input read and each output written once, in bf16).

- ``film_layer_bwd_work``: one call of the film layer's backward (K3);
- ``latent_train_flops``: the whole step's products (the chart encoder, the
  audio encoder and the decoder over the 2B window halves), the backward at
  twice the forward, no recompute.
"""

from __future__ import annotations

from .roofline import BF16, _stack, ffn_flops, latent_decode_flops, latent_encode_flops


def film_layer_bwd_work(B: int, L: int, C: int, H: int, K: int) -> tuple[float, int]:
    """K3 without recompute: the conv FFN's two data and two weight products of
    each projection (6 C x H) and the conv's input and weight gradients (2
    passes); reads x, dy, scale/shift/gate (B, C), the two gains and the
    FFN weights, writes dx, the FiLM vectors' gradients and the weights'"""
    weights = K * C + C + 2 * C * H + 2 * H + H * C + C + 2 * C
    return ffn_flops(B * L, C, H, K, 6, 2), BF16 * (3 * B * L * C + 2 * 3 * B * C + 2 * weights)


def chart_encode_flops(lat: dict, R: int, L: int) -> float:
    """the chart encoder of R items of L frames: the stem, the U-Net's
    stacks, the style stack and its attention pool, the temporal stack
    (FiLM on the style) and its projection"""
    C, s, E, S = lat["h_dim"], lat["stack"], lat["emb_dim"], lat["style_dim"]
    HD = lat["style_heads"] * lat["style_head_dim"]
    n, k = lat["n_downs"], lat["stride"]
    l = L // k ** n
    flops = 2.0 * R * L * 9 * C
    for i in range(n):
        flops += _stack(R * L // k ** i, C, s, 0, R)
    pool = 2.0 * R * l * (C * lat["style_heads"] + C * HD + HD) + 2.0 * R * HD * S
    stacks = _stack(R * l, C, s, 0, R) + _stack(R * l, C, s, S, R)
    return flops + stacks + pool + 2.0 * R * l * C * E


def latent_train_flops(cfg: dict, B: int, L: int) -> float:
    """one step over B windows of L frames, each split into two items of L / 2:
    the forward, and the backward at twice it"""
    lat, R, half = cfg["latent"], 2 * B, L // 2
    fwd = (chart_encode_flops(lat, R, half) + latent_encode_flops(lat, R, half)
           + latent_decode_flops(lat, R, half))
    return 3.0 * fwd
