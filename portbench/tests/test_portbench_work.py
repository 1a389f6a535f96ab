"""The operations and bytes the roofline shares count, at known shapes,
against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline as R


def test_k4_forward_at_the_predict_shape():
    # B4 L759 C512, H = int(512 * 4 * 2 / 3) = 1365, 5 taps: 3 C x H
    # products and one conv pass a row, two operations a multiply-add
    rows = 4 * 759
    assert R.swiglu_fwd_work(4, 759, 512, 1365, 5)[0] == rows * 2 * (3 * 512 * 1365 + 5 * 512)
    weights = 5 * 512 + 512 + 512 * 2730 + 2730 + 1365 * 512 + 512
    assert R.swiglu_fwd_work(4, 759, 512, 1365, 5)[1] == 2 * (2 * rows * 512 + weights)


def test_k6_backward_at_the_train_shape():
    rows = 128 * 152
    flops, nbytes = R.swiglu_bwd_work(128, 152, 512, 1365, 5)
    assert flops == rows * 2 * (6 * 512 * 1365 + 2 * 5 * 512)
    weights = 5 * 512 + 512 + 512 * 2730 + 2730 + 1365 * 512 + 512
    assert nbytes == 2 * (3 * rows * 512 + 2 * weights)  # x, dy, dx; weights and their grads


def test_long_backward_at_b64_l320():
    flops, nbytes = R.attention_bwd_work(64, 320, 16, 64, packed=False)
    assert flops == 4 * 2 * 64 * 16 * 320 * 320 * 64  # four L x L products a head
    n = 64 * 320 * 16 * 64
    assert nbytes == 2 * 8 * n + 4 * 64 * 320 * 16    # q k v o dO dq dk dv, f32 lse
    b = R.bound(flops, nbytes)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_attention_forward_and_bound():
    flops, nbytes = R.attention_fwd_work(4, 759, 16, 64)
    assert flops == 2 * 2 * 4 * 16 * 759 * 759 * 64
    assert nbytes == 2 * 4 * 4 * 759 * 16 * 64
    assert R.bound(989e12, 0)["bound_ms"] == pytest.approx(1e3)


def test_model_flops_add_up():
    d = {"emb_dim": 6, "a_dim": 128, "style_dim": 32, "global_cond_dim": 512,
         "backbone_dim": 512, "u_head_dim": 64,
         "backbone": {"depth": 8, "expand": 4, "head_dim": 64, "n_heads": 16, "radius": 2}}
    B, l = 2, 100
    per_layer = 2 * B * l * (128 * 512 + 512 * 3072 + 1024 * 512) + 4 * B * l * l * 1024 \
        + 2 * B * l * 3 * 512 * 1365 + 2 * B * 2 * 512 * 1536
    rest = 2 * B * l * (6 * 512 + 512 * 6 + 6 * 64 + 64 * 64) + 2 * B * 512 * 128
    assert R.denoiser_fwd_flops(d, B, l) == 8 * per_layer + rest
    cond = 2 * B * l * 128 * 128 + 2 * B * 32 * 512
    assert R.denoiser_train_flops({"diffusion": d}, B, l) == 3 * (8 * per_layer + rest + cond)
