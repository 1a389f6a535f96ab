"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work can take on it, and the operations and bytes of the model's parts
counted from their shapes.

``moved_bytes``, ``bound`` and ``ffn_flops`` are frozen copies of the
port's smoke check (chip_smoke.py), kept here so that a change to the
program cannot change the yardstick. Peaks: NVIDIA's data sheet for the
H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

BF16_PEAK, F32_PEAK, HBM_RATE = 989e12, 67e12, 3.35e12
BF16 = 2  # bytes an element of the compute dtype


def moved_bytes(*tensors) -> int:
    """bytes of the tensors among ``tensors`` (each read or written once)"""
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "element_size"))


def bound(flops: float, nbytes: int, peak: float = BF16_PEAK) -> dict:
    """the least time the card could take for the work, in ms, and which of
    operations and bytes sets it"""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def ffn_flops(rows: int, C: int, H: int, K: int, products: int, convs: int) -> int:
    """a conv FFN's operations over ``rows`` positions: ``products`` C x H
    products (the forward 3: the (C, 2H) and (H, C) projections; the
    backward 8: the recomputed (C, 2H), the two data and the two weight
    products) and ``convs`` K-tap conv passes, two operations a
    multiply-add"""
    return rows * 2 * (products * C * H + convs * K * C)


# ---------------------------------------------------- one call of a kernel ----
# Each returns (operations, bytes): every input read once and every output
# written once, in the compute dtype (bf16) unless said otherwise.

def swiglu_fwd_work(B: int, L: int, C: int, H: int, K: int) -> tuple[float, int]:
    """K4: x (B, L, C) -> out (B, L, C); weights (K, C), (C, 2H), (H, C)"""
    weights = K * C + C + 2 * C * H + 2 * H + H * C + C
    return ffn_flops(B * L, C, H, K, 3, 1), BF16 * (2 * B * L * C + weights)


def swiglu_bwd_work(B: int, L: int, C: int, H: int, K: int) -> tuple[float, int]:
    """the SwiGLU backward without recompute: the two data and the two weight
    products of each projection (6 C x H), the conv's input and weight
    gradients (2 passes); reads x, dy and the weights, writes dx and the
    weights' gradients"""
    weights = K * C + C + 2 * C * H + 2 * H + H * C + C
    return ffn_flops(B * L, C, H, K, 6, 2), BF16 * (3 * B * L * C + 2 * weights)


def film_layer_fwd_work(B: int, L: int, C: int, H: int, K: int) -> tuple[float, int]:
    """K2: the norm and FiLM, the conv FFN, the block norm and gated residual;
    reads x, scale/shift/gate (B, C), the two gains and the FFN weights,
    writes out"""
    weights = K * C + C + 2 * C * H + 2 * H + H * C + C + 2 * C
    return ffn_flops(B * L, C, H, K, 3, 1), BF16 * (2 * B * L * C + 3 * B * C + weights)


def attention_fwd_work(B: int, L: int, H: int, D: int) -> tuple[float, int]:
    """K7: q, k, v (B, L, H, D) -> out; the two L x L products of each head"""
    return 4.0 * B * H * L * L * D, BF16 * 4 * B * L * H * D


def attention_bwd_work(B: int, L: int, H: int, D: int, packed: bool) -> tuple[float, int]:
    """an attention backward without recompute: dV = P^T dO, dP = dO V^T,
    dQ = dS K, dK = dS^T Q (four L x L products a head). Reads q, k, v, out,
    dO and the f32 row statistics, writes dq, dk, dv; ``packed`` (K10) reads
    the packed qkv and writes dqkv and the two gains' gradients"""
    n = B * L * H * D
    nbytes = BF16 * (3 * n + 2 * n + 3 * n) + 4 * B * L * H
    if packed:
        nbytes += 2 * 4 * D
    return 8.0 * B * H * L * L * D, nbytes


# ------------------------------------------------------ whole-model FLOPs ----
# Matrix products and attention only (two operations a multiply-add): the
# work a model FLOPs utilization counts. Norms, activations and the
# depthwise convs are left out.

def _ffn(rows: int, C: int, expand: int) -> float:
    return 2.0 * rows * 3 * C * int(C * expand * 2 / 3)


def denoiser_fwd_flops(d: dict, B: int, l: int) -> float:
    """one denoiser prediction of B rows at latent length l (the per-row
    conditioning's products included)"""
    bb, C = d["backbone"], d["backbone_dim"]
    HD = bb["n_heads"] * bb["head_dim"]
    g, a, E, U = d["global_cond_dim"], d["a_dim"], d["emb_dim"], d["u_head_dim"]
    per_layer = (2.0 * B * l * (a * C + C * 3 * HD + HD * C) + 4.0 * B * l * l * HD
                 + _ffn(B * l, C, bb["expand"]) + 2.0 * B * 2 * g * 3 * C)
    rest = 2.0 * B * l * (E * C + C * E + E * U + U * U) + 2.0 * B * g * 2 * U
    return bb["depth"] * per_layer + rest


def denoiser_cond_flops(d: dict, B: int, l: int) -> float:
    return 2.0 * B * l * d["a_dim"] ** 2 + 2.0 * B * d["style_dim"] * d["global_cond_dim"]


def _stack(rows: int, C: int, s: dict, cond: int, B: int) -> float:
    return s["n_layers"] * (_ffn(rows, C, s["expand"]) + 2.0 * B * cond * 3 * C)


def latent_encode_flops(lat: dict, S: int, L: int) -> float:
    """the audio encoder of S songs of L frames"""
    C, s = lat["h_dim"], lat["stack"]
    w1 = (72 + 2 - 8) // 6 + 1
    w2 = (w1 + 2 - 6) // 4 + 1
    flops = 2.0 * S * L * (w1 * 8 * 3 * 8 + w2 * 32 * 8 * 3 * 6 + w2 * 32 * C)
    for i in range(lat["n_downs"]):
        flops += _stack(S * L // lat["stride"] ** i, C, s, 0, S)
    return flops


def latent_decode_flops(lat: dict, R: int, L: int) -> float:
    """the decoder of R rows of L frames, the label head included"""
    C, s, E, S = lat["h_dim"], lat["stack"], lat["emb_dim"], lat["style_dim"]
    n = lat["n_downs"]
    flops = 2.0 * R * (L // lat["stride"] ** n) * E * C + 2.0 * R * L * C * 9
    for i in range(n):
        rows = R * L // lat["stride"] ** (n - 1 - i)
        flops += 2.0 * rows * 2 * C * C + _stack(rows, C, s, S, R)
    return flops + 2.0 * R * (S * C + C * 5)


def style_sample_flops(st: dict, R: int, steps: int) -> float:
    h, e = st["h_dim"], st["expand"]
    per = 2.0 * R * (st["style_dim"] * h + st["depth"] * (h * 3 * h + 2 * h * e * h)
                     + h * st["style_dim"] + h)
    return (steps + 1) * per + 2.0 * R * 5 * st["label_features"] * h


def mapset_batch_flops(cfg: dict, S: int, D: int, out_frames: int) -> float:
    """one batch of S songs x D rows: encoder, style prior, the denoiser's
    steps + 1 predictions, decoder"""
    lat, smp = cfg["latent"], cfg["sampling"]
    l = out_frames // lat["stride"] ** lat["n_downs"]
    R = S * D
    return (latent_encode_flops(lat, S, out_frames)
            + style_sample_flops(cfg["style"], R, smp["style_steps"])
            + denoiser_cond_flops(cfg["diffusion"], R, l)
            + (smp["steps"] + 1) * denoiser_fwd_flops(cfg["diffusion"], R, l)
            + latent_decode_flops(lat, R, out_frames))


def denoiser_train_flops(cfg: dict, B: int, l: int) -> float:
    """one training step: the forward, and the backward at twice it (no recompute)"""
    d = cfg["diffusion"]
    return 3.0 * (denoiser_fwd_flops(d, B, l) + denoiser_cond_flops(d, B, l))
