"""Stage-3 training step for the style prior.

Counterpart of osu_dreamer_tpu/models/style/train.py: the denoiser's
distance-marching losses applied to style vectors (``osl`` and ``del``,
weights 1 and 30, with the ``u_mape`` metric), classifier-free label
dropout (each of the 5 labels independently replaced by -1 with probability
0.2 while training), AdamW with optax's semantics and an EMA copy updated
every step. ``t``, ``s0`` and the dropout mask are drawn from the state's
generator unless given (the parity tests inject them drawn the JAX way).
Data-parallel steps (``par``): the three draws are made at the global batch
and each rank takes its rows; the metrics are averaged over the data ranks
and the gradients over all ranks. No leaf of the style prior matches the
tensor-parallel rules (parallel/tp.py): under ``tp`` every rank holds the
whole model, a model group's ranks compute the same rows, and the gradients
are averaged over the data group, as the JAX package's ``fit-style`` runs
under tp.

The validation suite on the EMA model (``evaluate_style``) draws a stack of
samples per label row and scores it against the real codes
(``sample_metrics``): nearest-neighbour distance ratios (all rows, and rows
of sr >= 5), per-condition recall, same-condition spread and the energy
distance. The real-to-real nearest neighbour excludes each code itself by an
infinite diagonal: the JAX code writes ``d + inf * eye(B)``, whose
off-diagonal ``0 * inf`` is NaN when run eagerly; its metrics run jitted,
where XLA computes the diagonal mask, and that is what the port computes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from ...train.state import (
    OptimizerArgs, TrainState, ema_update, make_optimizer, stratified_logit_normal_t,
)
from .model import StyleModel, StyleModelArgs


@dataclass
class StyleTrainArgs:
    opt: OptimizerArgs = field(default_factory=lambda: OptimizerArgs(lr=3e-4))
    label_drop_prob: float = 0.2
    osl_weight: float = 1.0
    del_weight: float = 30.0
    ema_decay: float = 0.99


def style_loss(
    model: StyleModel,
    s1: torch.Tensor,      # (B, S) real style codes
    labels: torch.Tensor,  # (B, NUM_LABELS)
    args: StyleTrainArgs,
    generator: torch.Generator | None = None,
    train: bool = True,
    t: torch.Tensor | None = None,
    s0: torch.Tensor | None = None,
    drop: torch.Tensor | None = None,
    par=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """-> (loss, {"loss", "osl", "del", "u_mape"}) over this rank's rows;
    ``t`` (B,), ``s0`` (B, S) and the label-dropout mask ``drop`` (B,
    NUM_LABELS), at the global batch under ``par``, are drawn from
    ``generator`` unless given (no dropout unless ``train``)"""
    B, dev = s1.shape[0], s1.device
    n = par.n_data if par is not None else 1
    take = (lambda x: par.take_rows(x, B)) if par is not None else (lambda x: x)
    if t is None:
        t = stratified_logit_normal_t(B * n, generator, dev)
    s1 = s1.float()
    if s0 is None:
        s0 = torch.randn((B * n, s1.shape[1]), generator=generator, device=dev)
    t, s0 = take(t), take(s0)
    st = s0 + t[:, None] * (s1 - s0)

    if train and args.label_drop_prob > 0:
        if drop is None:
            drop = torch.rand((B * n, labels.shape[1]), generator=generator,
                              device=dev) < args.label_drop_prob
        labels = torch.where(take(drop), torch.full_like(labels, -1.0), labels)

    u_pred, v_pred = model(st, labels)
    v_pred = v_pred.float()

    c0 = model.args.c0
    d_sq = ((st - s1) ** 2).sum(dim=1)
    u_target = torch.sqrt(d_sq + c0)

    denoised = st - u_pred[:, None] * v_pred
    osl = (((denoised - s1) ** 2).sum(dim=1) / (d_sq + c0)).mean()

    v_target = (st - s1) / u_target[:, None]
    del_ = ((v_pred - v_target) ** 2).sum(dim=1).mean()

    loss = args.osl_weight * osl + args.del_weight * del_
    u_mape = ((u_pred - u_target).abs() / u_target).mean()
    return loss, {"loss": loss, "osl": osl, "del": del_, "u_mape": u_mape}


def step_gradients(model: StyleModel, batch, args: StyleTrainArgs,
                   generator: torch.Generator | None = None, t=None, s0=None, drop=None,
                   par=None) -> tuple[dict[str, torch.Tensor], list[torch.Tensor]]:
    """one step's metrics (averaged over the data ranks) and parameter
    gradients (averaged over the ranks, parallel/config.py
    ``average_gradients``) -> (metrics, gradients)"""
    s, labels = batch
    loss, aux = style_loss(model, s, labels, args, generator, t=t, s0=s0, drop=drop, par=par)
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    if par is None:
        return {k: v.detach() for k, v in aux.items()}, grads
    return par.mean_over_data(aux), par.average_gradients(grads)


def make_train_step(args: StyleTrainArgs, par=None):
    """-> step(state, (s, labels), t=None, s0=None, drop=None) -> metrics:
    one update of the state in place (loss gradient, clip + AdamW, EMA,
    step + 1); under ``par`` the batch is this rank's rows and the draws are
    global"""

    def train_step(state: TrainState, batch, t=None, s0=None, drop=None) -> dict:
        metrics, grads = step_gradients(state.model, batch, args, state.generator, t, s0, drop,
                                        par)
        state.opt.step(grads)
        ema_update(state.ema_model, state.model, args.ema_decay)
        state.step += 1
        return metrics

    return train_step


def init_style_training(
    model_args: StyleModelArgs,
    train_args: StyleTrainArgs,
    seed: int,
    device: torch.device | str,
    dtype: torch.dtype,
    par=None,
):
    """-> (state, train_step). The parameters are drawn on the CPU from
    ``seed`` (flax's initialisation, the same on every device); the steps'
    generator lives on ``device``, seeded ``seed + 1``"""
    model = StyleModel(model_args, dtype).init_params(torch.Generator().manual_seed(seed))
    model = model.to(device)
    ema = copy.deepcopy(model).requires_grad_(False)
    state = TrainState(
        step=0,
        model=model,
        opt=make_optimizer(list(model.parameters()), train_args.opt),
        ema_model=ema,
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
    return state, make_train_step(train_args, par)


# ------------------------------------------------------------ validation --


def _cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, S), (..., M, S) -> (..., N, M) distances, floored at 1e-6"""
    d2 = ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
    return torch.sqrt(d2.clamp_min(1e-12))


def energy_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """E-distance between two sample sets"""

    def offdiag_mean(a):
        n = a.shape[0]
        eye = torch.eye(n, device=a.device, dtype=a.dtype)
        return (_cdist(a, a) * (1 - eye)).sum() / (n * (n - 1))

    return 2 * _cdist(x, y).mean() - offdiag_mean(x) - offdiag_mean(y)


def _real_nn(s_real: torch.Tensor) -> torch.Tensor:
    """mean real-to-real nearest-neighbour distance, each code's distance to
    itself excluded"""
    B = s_real.shape[0]
    eye = torch.eye(B, device=s_real.device, dtype=torch.bool)
    return _cdist(s_real, s_real).masked_fill(eye, float("inf")).min(dim=1).values.mean()


def nn_ratio(samp: torch.Tensor, s_real: torch.Tensor) -> torch.Tensor:
    """samples (K, B, S) -> mean sample-to-real nearest distance over the
    real codes' own"""
    flat = samp.reshape(-1, samp.shape[-1])
    return _cdist(flat, s_real).min(dim=1).values.mean() / _real_nn(s_real)


def sample_metrics(samp: torch.Tensor, s_real: torch.Tensor) -> dict[str, torch.Tensor]:
    """the metric suite of K samples per label row (K, B, S) against the
    real codes (B, S)"""
    k, B = samp.shape[:2]
    flat = samp.reshape(-1, samp.shape[-1])
    per_cond = samp.transpose(0, 1)  # (B, K, S)
    pair = _cdist(per_cond, per_cond).sum()
    return {
        "nn_ratio": nn_ratio(samp, s_real),
        "cond_recall": torch.linalg.vector_norm(samp - s_real[None], dim=-1).min(dim=0)
        .values.mean(),
        "energy_dist": energy_distance(flat, s_real),
        "sample_spread": pair / (k * (k - 1) * B) / _real_nn(s_real),
    }


def sample_stack(model: StyleModel, labels: torch.Tensor, generator: torch.Generator,
                 num_samples: int, sample_steps: int) -> torch.Tensor:
    """``num_samples`` style samples per label row -> (K, B, S) f32"""
    return torch.stack([model.sample(labels, sample_steps, generator=generator).float()
                        for _ in range(num_samples)])


@torch.no_grad()
def evaluate_style(
    model: StyleModel,
    s_real: torch.Tensor,
    labels: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 4,
    sample_steps: int = 16,
) -> dict[str, float]:
    """generative quality metrics of ``model`` (the EMA model): the suite
    over every row, and ``nn_ratio_sr5`` over fresh samples of the rows with
    sr >= 5 where there are at least two"""
    if s_real.shape[0] < 2:
        return {}
    s_real = s_real.float()
    samp = sample_stack(model, labels, generator, num_samples, sample_steps)
    out = {k: float(v) for k, v in sample_metrics(samp, s_real).items()}
    hi = labels[:, 0] >= 5.0
    if int(hi.sum()) > 1:
        samp_hi = sample_stack(model, labels[hi], generator, num_samples, sample_steps)
        out["nn_ratio_sr5"] = float(nn_ratio(samp_hi, s_real[hi]))
    return out

