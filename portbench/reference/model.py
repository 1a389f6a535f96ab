"""Plain float32 PyTorch of osu!dreamer's three models, written from their
equations: the latent WAE's audio encoder and chart decoder, the style
prior and its sphere-tracing sampler, and the latent denoiser with its
sampler and training loss.

Every function takes the weights as one dict keyed by the parameter names
the benchmark drew them under, and a ``Numerics`` that says how its matrix
products round (numerics.py). It imports nothing of the program under test.
Sizes come from the configuration's JSON dict (configs/*.json).
"""

from __future__ import annotations

import math
from functools import cache
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

HIT_DIM = 7          # the chart's hit channels; the last two are cursor x, y
NUM_LABELS = 5       # sr, ar, od, cs, hp
T99 = 0.9110007125548362
EPS = 1e-6
RFF_TABLES = Path(__file__).with_name("rff_tables.npz")


def rms(x: torch.Tensor, gamma: torch.Tensor | None = None) -> torch.Tensor:
    out = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS)
    return out if gamma is None else out * gamma


def dense(P: dict, name: str, x: torch.Tensor, nx: Numerics) -> torch.Tensor:
    return nx.mm(x, P[f"{name}.kernel"]) + P[f"{name}.bias"]


def dwconv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """zero-padded SAME depthwise conv over (B, L, C); kernel (K, C) or
    (K, 1, C), the first tap reading (K - 1) // 2 frames back"""
    kernel = kernel.reshape(kernel.shape[0], -1)
    K, L = kernel.shape[0], x.shape[1]
    lo = (K - 1) // 2
    xp = F.pad(x, (0, 0, lo, K - 1 - lo))
    return sum(xp[:, i:i + L] * kernel[i] for i in range(K)) + bias


def swiglu(P: dict, name: str, x: torch.Tensor, nx: Numerics) -> torch.Tensor:
    """depthwise conv, then the gated FFN with an RMS norm on the gated units"""
    y = dwconv(x, P[f"{name}.dw_kernel"], P[f"{name}.dw_bias"])
    v, g = (nx.mm(y, P[f"{name}.vg_kernel"]) + P[f"{name}.vg_bias"]).chunk(2, dim=-1)
    return nx.mm(rms(v * F.silu(g)), P[f"{name}.out_kernel"]) + P[f"{name}.out_bias"]


def film_stack(P: dict, name: str, x: torch.Tensor, cond: torch.Tensor | None, n_layers: int,
               nx: Numerics) -> torch.Tensor:
    """n pre-norm residual SwiGLU layers, FiLM-modulated by ``cond``:
    x + rms(ffn(rms(x) g1 (1 + scale) + shift)) g2 (1 + gate); then a norm"""
    for i in range(n_layers):
        if cond is None:
            scale = shift = gate = torch.zeros_like(x[:, :1])
        else:
            scale, shift, gate = (t[:, None] for t in
                                  dense(P, f"{name}.film{i}", cond, nx).chunk(3, dim=-1))
        h = rms(x, P[f"{name}.norm{i}.gamma"]) * (1 + scale) + shift
        h = swiglu(P, f"{name}.ffn{i}", h, nx)
        x = x + rms(h, P[f"{name}.blocknorm{i}.gamma"]) * (1 + gate)
    return rms(x, P[f"{name}.out_norm.gamma"])


# ------------------------------------------------------------------ latent ----

def spec_features(P: dict, spec: torch.Tensor, nx: Numerics) -> torch.Tensor:
    """(B, L, 72) -> (B, L, h): two strided convs over (time, freq), padding
    1, the flatten in (freq, channel) order, a projection"""
    pre = "latent.spec_stem"

    def conv(x, name, stride):  # x (B, L, W, C) channel-last
        y = nx.conv2d(x.permute(0, 3, 1, 2), P[f"{pre}.{name}.kernel"], stride, (1, 1))
        return y.permute(0, 2, 3, 1) + P[f"{pre}.{name}.bias"]

    x = F.silu(rms(conv(spec[..., None], "c1", (1, 6)), P[f"{pre}.n1.gamma"]))
    x = F.silu(rms(conv(x, "c2", (1, 4)), P[f"{pre}.n2.gamma"]))
    B, L = x.shape[:2]
    return F.silu(rms(dense(P, f"{pre}.proj", x.reshape(B, L, -1), nx), P[f"{pre}.n3.gamma"]))


def encode_audio(P: dict, cfg: dict, spec: torch.Tensor, nx: Numerics):
    """-> (skips, h at the latent rate): the audio U-Net encoder"""
    a = cfg["latent"]
    x = spec_features(P, spec, nx)
    skips = []
    for i in range(a["n_downs"]):
        x = film_stack(P, f"latent.audio_unet.stack{i}", x, None, a["stack"]["n_layers"], nx)
        skips.append(x)
        x = dwconv(x, P[f"latent.audio_unet.down{i}.dw.kernel"],
                   P[f"latent.audio_unet.down{i}.dw.bias"])
        B, L, C = x.shape
        x = x.reshape(B, L // a["stride"], a["stride"], C).mean(dim=2)
    return skips, x


def decode(P: dict, cfg: dict, z: torch.Tensor, s: torch.Tensor, skips: list, nx: Numerics):
    """-> (chart (B, L, 9) with sigmoided hit channels, labels in [0, 10])"""
    a = cfg["latent"]
    x = dense(P, "latent.emb_proj", z, nx)
    for i in range(a["n_downs"]):
        pre = f"latent.decoder.{{}}{i}"
        x = dwconv(x.repeat_interleave(a["stride"], dim=1), P[pre.format("up") + ".dw.kernel"],
                   P[pre.format("up") + ".dw.bias"])
        skip = skips[-(i + 1)]
        skip = skip.expand(x.shape[0], *skip.shape[1:])
        mix = pre.format("mix")
        x = x + rms(dense(P, f"{mix}.proj", skip, nx), P[f"{mix}.norm.gamma"]) \
            * dense(P, f"{mix}.gate", x, nx)
        x = film_stack(P, pre.format("stack"), x, s, a["stack"]["n_layers"], nx)
    logits = dense(P, "latent.head", x, nx)
    chart = torch.cat([logits[..., :HIT_DIM].sigmoid(), logits[..., HIT_DIM:]], dim=-1)
    labels = dense(P, "latent.label_mlp.layers_2",
                   F.silu(dense(P, "latent.label_mlp.layers_0", s, nx)), nx)
    return chart, labels.clamp(0.0, 10.0)


# ------------------------------------------------------------------- style ----

@cache
def _rff(features: int) -> tuple[np.ndarray, np.ndarray]:
    with np.load(RFF_TABLES) as t:
        return t[f"W_1x{features}"], t[f"b_{features}"]


def embed_labels(P: dict, cfg: dict, labels: torch.Tensor, nx: Numerics) -> torch.Tensor:
    """(B, 5) -> (B, h): random Fourier features of label / 10 (W scaled by
    32 bins), a per-label projection, the learned null row where a label is
    negative, summed over the labels"""
    F_ = cfg["style"]["label_features"]
    W, b = (torch.from_numpy(t).to(labels.device) for t in _rff(F_))
    x = labels[:, :, None]
    rff = (2.0 / F_) ** 0.5 * torch.cos((x / 10.0) @ (W * 32.0) + b)
    h = nx.einsum("bnf,nfh->bnh", rff, P["style.label_proj_w"]) + P["style.label_proj_b"]
    return torch.where(x < 0, P["style.null_labels"][None], h).sum(dim=1)


def style_predict(P: dict, cfg: dict, st: torch.Tensor, c: torch.Tensor, nx: Numerics):
    """-> (u (B,), v (B, style_dim))"""
    a = cfg["style"]
    x = dense(P, "style.proj_in", st, nx)
    for i in range(a["depth"]):
        scale, shift, gate = dense(P, f"style.film{i}", c, nx).chunk(3, dim=-1)
        h = rms(x) * (1 + scale) + shift
        h = dense(P, f"style.block{i}.layers_2",
                  F.silu(dense(P, f"style.block{i}.layers_0", h, nx)), nx)
        x = x + rms(h) * gate
    v = dense(P, "style.proj_out", rms(x, P["style.out_gamma"]), nx)
    u = math.sqrt(2.0 * a["style_dim"]) * F.softplus(dense(P, "style.u_out", rms(x), nx))[:, 0]
    return u, v


def sphere_trace(predict, x0: torch.Tensor, dim: int, steps: int) -> torch.Tensor:
    """x <- x - eta u v from x0, eta from the first distance's mean over all
    rows: (1 - eta)^steps takes that mean down to sqrt(c0)"""
    sqrt_c0 = math.sqrt((1.0 - T99) ** 2 * 2.0 * dim)
    u0 = predict(x0)[0].mean()
    eta = 1.0 - (sqrt_c0 / u0.clamp_min(sqrt_c0 + 1e-6)) ** (1.0 / steps)
    x = x0
    for _ in range(steps):
        u, v = predict(x)
        x = x - eta * u.reshape(-1, *[1] * (x.dim() - 1)) * v
    return x


def style_sample(P: dict, cfg: dict, labels: torch.Tensor, s0: torch.Tensor, steps: int,
                 guidance: float, nx: Numerics) -> torch.Tensor:
    if guidance != 1.0:
        raise NotImplementedError("the reference samples the style at guidance 1")
    c = embed_labels(P, cfg, labels, nx)
    return sphere_trace(lambda s: style_predict(P, cfg, s, c, nx), s0, cfg["style"]["style_dim"],
                        steps)


# --------------------------------------------------------------- denoiser ----

def rope(x: torch.Tensor) -> torch.Tensor:
    """rotary embedding over (B, L, H, D), halves rotated by position / 10000^(2i/D)"""
    _, L, _, D = x.shape
    inv = 10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / -D)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(P: dict, name: str, h: torch.Tensor, H: int, D: int, nx: Numerics) -> torch.Tensor:
    """packed qkv, per-head RMS norm of q and k with gains, RoPE, softmax
    attention over all positions, output projection"""
    B, L, _ = h.shape
    q, k, v = (t.reshape(B, L, H, D) for t in dense(P, f"{name}.qkv", h, nx).split(H * D, -1))
    q = rope(rms(q, P[f"{name}.q_gamma"]))
    k = rope(rms(k, P[f"{name}.k_gamma"]))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))                       # (B, H, L, D)
    s = nx.mm(q, k.transpose(-1, -2)) / math.sqrt(D)
    y = nx.mm(s.softmax(dim=-1), v).transpose(1, 2).reshape(B, L, H * D)
    return dense(P, f"{name}.out", y, nx)


def denoiser_cond(P: dict, audio: torch.Tensor, style: torch.Tensor, nx: Numerics):
    return (F.silu(dense(P, "diffusion.audio_in", audio, nx)),
            F.silu(dense(P, "diffusion.style_in", style, nx)))


def denoiser_predict(P: dict, cfg: dict, audio_c: torch.Tensor, cond: torch.Tensor,
                     xt: torch.Tensor, nx: Numerics):
    """-> (u (B,), v (B, l, E)): the FiLM-gated transformer backbone for v,
    the conv head over xt's frames, time-averaged, for u"""
    a, bb = cfg["diffusion"], cfg["diffusion"]["backbone"]
    x = dense(P, "diffusion.proj_in", xt, nx)
    for i in range(bb["depth"]):
        pre = f"diffusion.net.layer{i}"
        scale, shift, gate = (t[:, None] for t in
                              dense(P, f"{pre}.film_attn", cond, nx).chunk(3, dim=-1))
        h = rms(x) * (1 + scale) + shift + dense(P, f"{pre}.audio_proj", audio_c, nx)
        h = attention(P, f"{pre}.attn", h, bb["n_heads"], bb["head_dim"], nx)
        x = x + rms(h) * gate
        scale, shift, gate = (t[:, None] for t in
                              dense(P, f"{pre}.film_ffn", cond, nx).chunk(3, dim=-1))
        h = swiglu(P, f"{pre}.ffn", rms(x) * (1 + scale) + shift, nx)
        x = x + rms(h) * gate
    v = dense(P, "diffusion.proj_out", rms(x), nx)
    pre = "diffusion.u_convs"
    f = dwconv(xt, P[f"{pre}.layers_0.kernel"], P[f"{pre}.layers_0.bias"])
    f = F.silu(dense(P, f"{pre}.layers_1", f, nx))
    f = dwconv(f, P[f"{pre}.layers_3.kernel"], P[f"{pre}.layers_3.bias"])
    f = F.silu(dense(P, f"{pre}.layers_4", f, nx)).mean(dim=1)
    scale, shift = dense(P, "diffusion.u_film", cond, nx).chunk(2, dim=-1)
    f = f * (1 + scale) + shift
    u = math.sqrt(2.0 * a["emb_dim"]) * F.softplus(dense(P, "diffusion.u_out", f, nx))[:, 0]
    return u, v


def denoiser_sample(P: dict, cfg: dict, audio: torch.Tensor, style: torch.Tensor,
                    x0: torch.Tensor, steps: int, nx: Numerics) -> torch.Tensor:
    audio_c, cond = denoiser_cond(P, audio, style, nx)
    return sphere_trace(lambda x: denoiser_predict(P, cfg, audio_c, cond, x, nx), x0,
                        cfg["diffusion"]["emb_dim"], steps)


def frame_dist_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """squared distance: sum over channels, mean over frames"""
    return (a - b).square().sum(-1).mean(-1)


def denoiser_loss(P: dict, cfg: dict, h, z, s, t, x0, nx: Numerics, osl_weight: float,
                  del_weight: float) -> torch.Tensor:
    """the distance-marching loss: one-step denoising weighted by the inverse
    distance, plus the eikonal direction term"""
    emb = cfg["diffusion"]["emb_dim"]
    c0 = (1.0 - T99) ** 2 * 2.0 * emb
    xt = x0 + t[:, None, None] * (z - x0)
    u, v = denoiser_predict(P, cfg, *denoiser_cond(P, h, s, nx), xt, nx)
    d_sq = frame_dist_sq(xt, z)
    u_target = torch.sqrt(d_sq + c0)
    osl = (frame_dist_sq(xt - u[:, None, None] * v, z) / (d_sq + c0)).mean()
    del_ = frame_dist_sq(v, (xt - z) / u_target[:, None, None]).mean()
    return osl_weight * osl + del_weight * del_
