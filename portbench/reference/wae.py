"""Plain float32 PyTorch of the chart WAE's training step, written from its
equations: the chart encoder, the WAE-MMD term, the latent loss and the
first steps of training with the optimizer of optax's
``chain(clip_by_global_norm, adamw)`` and the loss's running normalisation
(no EMA model in this stage).

Built on model.py's FiLM stacks, dense layers, norms, depthwise convs and
audio encoder, and on chain.py's optimizer. The decoder is model.py's
``decode`` up to its head: the loss reads the head's logits and the label
MLP's unclamped output, where ``decode`` sigmoids the one and clamps the
other. Weights are one dict keyed as the benchmark drew them (``latent.*``);
every function takes a ``TrainNumerics`` (numerics.py's ``Numerics`` with
the tensors it holds). It imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as M
from .chain import AdamW
from .numerics import E5M2, Numerics, fp8

# hit channels x7, cursor position / velocity / acceleration, labels
LOSS_WEIGHTS = (1.0,) * M.HIT_DIM + (2.0, 2.0, 2.0, 6.0)
IMQ_SCALES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)


class _Fp8Conv2d(torch.autograd.Function):
    """a 2-D conv on e4m3 operands; its two backward convs on the e5m2
    gradient and the saved e4m3 operands (numerics.py's product rule)"""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = fp8(x), fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.conv = (stride, padding)
        return F.conv2d(qx, qw, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        qx, qw = ctx.saved_tensors
        qg = fp8(grad, E5M2)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, *ctx.conv)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, *ctx.conv)
        return gx, gw, None, None


class _Fp8Held(torch.autograd.Function):
    """a tensor held in e4m3, its gradient in e5m2"""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8(grad, E5M2)


class TrainNumerics(Numerics):
    """``Numerics`` whose spectrogram-stem convolutions take gradients in both
    precisions (numerics.py's fp8 ``conv2d`` is forward only). In fp8 the
    tensors that the program holds in its compute dtype are held in fp8 too
    (``hold``): every product's and convolution's output, each U-Net level's
    output and skip, the style and latent codes, the head's logits and the
    label predictions (numerics.py's control rounds the products' operands
    alone)"""

    def hold(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kind == "f32" else _Fp8Held.apply(t)

    def mm(self, a, b):
        return self.hold(super().mm(a, b))

    def conv2d(self, x, w, stride, padding):
        if self.kind == "f32":
            return F.conv2d(x.float(), w.float(), stride=stride, padding=padding)
        return self.hold(_Fp8Conv2d.apply(x.float(), w.float(), stride, padding))


def split_halves(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) -> (2B, L / 2, C): each window's two halves, in order"""
    B, L, C = x.shape
    return x.reshape(2 * B, L // 2, C)


def unet_encode(P: dict, cfg: dict, name: str, x: torch.Tensor, nx: Numerics):
    """-> (skips, bottom): at each level a FiLM-free stack, its output kept as
    a skip, a depthwise conv and a mean over ``stride`` frames"""
    a = cfg["latent"]
    skips = []
    for i in range(a["n_downs"]):
        x = nx.hold(M.film_stack(P, f"{name}.stack{i}", x, None, a["stack"]["n_layers"], nx))
        skips.append(x)
        x = M.dwconv(x, P[f"{name}.down{i}.dw.kernel"], P[f"{name}.down{i}.dw.bias"])
        B, L, C = x.shape
        x = nx.hold(x.reshape(B, L // a["stride"], a["stride"], C).mean(dim=2))
    return skips, x


def attn_pool(P: dict, name: str, x: torch.Tensor, heads: int, head_dim: int,
              nx: Numerics) -> torch.Tensor:
    """(B, l, C) -> (B, out): a softmax over the frames for each head, the
    values summed under it, the heads projected"""
    B, l, _ = x.shape
    w = M.dense(P, f"{name}.scores", x, nx).softmax(dim=1)                     # (B, l, H)
    v = M.dense(P, f"{name}.values", x, nx).reshape(B, l, heads, head_dim)
    pooled = nx.mm(w.transpose(1, 2)[:, :, None], v.transpose(1, 2))         # (B, H, 1, D)
    return M.dense(P, f"{name}.out", pooled.reshape(B, heads * head_dim), nx)


def encode_chart(P: dict, cfg: dict, chart: torch.Tensor, nx: Numerics):
    """(B, L, 9) -> (z (B, L / stride^n_downs, emb), s (B, style)), each RMS
    normalised without a gain: the style from the bottom level's style
    stack and pool, the latent from the temporal stack FiLM-conditioned on
    the style"""
    a = cfg["latent"]
    n = a["stack"]["n_layers"]
    _, bottom = unet_encode(P, cfg, "latent.chart_encoder",
                            M.dense(P, "latent.chart_stem", chart, nx), nx)
    pooled = attn_pool(P, "latent.style_pool", M.film_stack(P, "latent.style_stack", bottom, None,
                                                            n, nx),
                       a["style_heads"], a["style_head_dim"], nx)
    s = nx.hold(M.rms(pooled))
    z = nx.hold(M.rms(M.dense(P, "latent.temporal_proj",
                              M.film_stack(P, "latent.temporal_stack", bottom, s, n, nx), nx)))
    return z, s


def decode_logits(P: dict, cfg: dict, z: torch.Tensor, s: torch.Tensor, skips: list,
                  nx: Numerics):
    """-> (chart logits (B, L, 9), label predictions (B, 5)): model.py's
    ``decode`` before its sigmoid and its clamp"""
    a = cfg["latent"]
    x = M.dense(P, "latent.emb_proj", z, nx)
    for i in range(a["n_downs"]):
        pre = f"latent.decoder.{{}}{i}"
        x = M.dwconv(x.repeat_interleave(a["stride"], dim=1), P[pre.format("up") + ".dw.kernel"],
                     P[pre.format("up") + ".dw.bias"])
        mix = pre.format("mix")
        x = x + M.rms(M.dense(P, f"{mix}.proj", skips[-(i + 1)], nx), P[f"{mix}.norm.gamma"]) \
            * M.dense(P, f"{mix}.gate", x, nx)
        x = nx.hold(M.film_stack(P, pre.format("stack"), x, s, a["stack"]["n_layers"], nx))
    labels = M.dense(P, "latent.label_mlp.layers_2",
                     F.silu(M.dense(P, "latent.label_mlp.layers_0", s, nx)), nx)
    return nx.hold(M.dense(P, "latent.head", x, nx)), nx.hold(labels)


def mmd_imq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """the unbiased MMD^2 between samples x and y (n, d each) under the sum of
    inverse multiquadratic kernels C / (C + |a - b|^2), C = 2 d x scale, in
    float32 (the program keeps this term in float32 whatever its compute)"""
    n, d = x.shape

    def k(a, b):
        sq = (a[:, None] - b[None]).square().sum(-1)
        return sum(2.0 * d * c / (2.0 * d * c + sq) for c in IMQ_SCALES)

    off = 1.0 - torch.eye(n, device=x.device)
    return ((k(x, x) * off).sum() + (k(y, y) * off).sum()) / (n * (n - 1)) - 2.0 * k(x, y).mean()


def binary_entropy(t: torch.Tensor) -> torch.Tensor:
    return -(torch.special.xlogy(t, t) + torch.special.xlogy(1 - t, 1 - t))


def latent_loss(P: dict, cfg: dict, audio, chart, labels, draws, nx: Numerics):
    """-> (the 11 loss components, the MMD term) of one batch of windows
    (audio (B, L, 72), chart (B, L, 9), labels (B, 5)) under ``draws`` (the
    seven draws of wae_traffic.py, for the 2B halves). Each window's halves
    are two items whose style codes are exchanged before decoding; the
    style and latent take noise, a masked style item takes a prior draw in
    its place, and each item's latent is zeroed over a span (lengths and
    starts truncated toward zero, as an int32 cast does). The losses: each
    hit channel's BCE minus its target's entropy, the cursor's squared error
    on its values and first and second frame differences, and the labels'
    over the items whose style was kept."""
    tr = cfg["train"]
    prior, s_noise, z_noise, s_mask, s_repl, span, start = draws
    audio, chart = split_halves(audio), split_halves(chart)
    labels = labels.repeat_interleave(2, dim=0)
    z, s = encode_chart(P, cfg, chart, nx)
    s_reg = mmd_imq(s, prior)
    s = s.reshape(-1, 2, s.shape[-1]).flip(1).reshape(s.shape)
    s = nx.hold(s + tr["s_noise"] * s_noise)
    z = nx.hold(z + tr["z_noise"] * z_noise)
    masked = s_mask < tr["s_mask_frac"]
    s = torch.where(masked[:, None], s_repl, s)
    l = z.shape[1]
    length = (span * tr["z_mask_frac"] * l).to(torch.int32)
    first = (start * (l - length).clamp_min(1).float()).to(torch.int32)
    frame = torch.arange(l, device=z.device)[None]
    zeroed = (frame >= first[:, None]) & (frame < (first + length)[:, None])
    z = z.masked_fill(zeroed[:, :, None], 0.0)
    skips = [nx.hold(x) for x in M.encode_audio(P, cfg, audio, nx)[0]]
    logits, pred_labels = decode_logits(P, cfg, z, s, skips, nx)

    hit_t, hit = chart[..., :M.HIT_DIM], logits[..., :M.HIT_DIM]
    bce = F.binary_cross_entropy_with_logits(hit, hit_t, reduction="none")
    hits = (bce - binary_entropy(hit_t)).mean(dim=(0, 1))
    xy_t, xy = chart[..., M.HIT_DIM:], logits[..., M.HIT_DIM:]
    cursor = [(torch.diff(xy, n=k, dim=1) - torch.diff(xy_t, n=k, dim=1)).square().mean()
              if k else (xy - xy_t).square().mean() for k in range(3)]
    kept = ~masked
    label_err = (pred_labels - labels).square().mean(dim=1)
    label = (label_err * kept).sum() / kept.sum().clamp_min(1)
    return torch.stack([*hits, *cursor, label]), s_reg


def train_steps(P0: dict, cfg: dict, batches: list, draws: list, nx: Numerics,
                rows: slice | None = None) -> dict:
    """n steps from the weights ``P0`` (left as they are) on ``batches``
    ((audio, chart, labels) each) with ``draws`` (a step's seven each). Each
    step's loss is the components weighted and divided by their running
    magnitude (the first step's own values, then an EMA of 0.01 a step),
    plus the MMD term; ``rows`` keeps only those windows of each batch and
    their halves' draws (a fault the checks must catch). -> {"components":
    [n x 11 floats], "s_reg": [n floats], "grad": the first step's clipped
    gradients, "params": the weights after n steps}"""
    tr = cfg["train"]
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    opt = AdamW(P, tr["opt"])
    weights = torch.tensor(LOSS_WEIGHTS, device=next(iter(P.values())).device)
    running, first = None, None
    components, s_regs = [], []
    for batch, drawn in zip(batches, draws):
        batch = [t.float() for t in batch]
        drawn = [t.float() for t in drawn]
        if rows is not None:
            items = slice(2 * rows.start, 2 * rows.stop)
            batch, drawn = [t[rows] for t in batch], [t[items] for t in drawn]
        leaves = {k: v.requires_grad_() for k, v in P.items()}
        comps, s_reg = latent_loss(leaves, cfg, *batch, drawn, nx)
        seen = comps.detach()
        scale = seen if running is None else running
        total = (weights * comps / scale.clamp_min(1e-8)).sum() + tr["s_reg_weight"] * s_reg
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        for v in P.values():
            v.requires_grad_(False)
        clipped = opt.step(grads)
        first = clipped if first is None else first
        running = seen if running is None else running * 0.99 + seen * 0.01
        components.append(seen.tolist())
        s_regs.append(float(s_reg.detach()))
    return {"components": components, "s_reg": s_regs, "grad": first, "params": P}
