"""The port's routes on the card, pinned to the JAX package's dispatch.

Each route is decided before any launch, from shapes alone, so it is tested
here on the CPU with device type "cuda". The rules: no shape routes to a
port kernel that refuses it, and no shape at which the JAX package runs a
Pallas kernel routes to a plain version (the plain route is taken only where
the JAX package itself computes without Pallas). Widths follow the models'
rule at expand 4, radius 2: H = int(C * 4 * 2 / 3), K = 5.
"""

from __future__ import annotations

import pytest
import torch

from osu_dreamer_tpu.ops import film_layer as jfl
from osu_dreamer_tpu.ops import film_qkv as jfq
from osu_dreamer_tpu.ops import swiglu as jsw
from osu_dreamer_tpu.ops._tiles import shrink_tile_to_budget
from osu_dreamer_tpu.ops.fused_attention import fused_attention_fits as jfused_fits
from osu_dreamer_tpu.ops.long_attention import long_attention_fits as jlong_fits
from osu_dreamer_tpu_torch.nn.attention import prologue_ok, prologue_tp_ok
from osu_dreamer_tpu_torch.ops import film_layer as fl
from osu_dreamer_tpu_torch.ops import film_qkv as fq
from osu_dreamer_tpu_torch.ops import fused_attention as fa
from osu_dreamer_tpu_torch.ops import swiglu as sw
from osu_dreamer_tpu_torch.parallel.tp import even_split

WIDTHS = [64, 128, 256, 384, 512, 640, 768, 1024]
K = 5


def _hidden(C: int) -> int:
    return int(C * 4 * 2 / 3)


# the JAX gate's range: the templated head dims (32, 64, 128), the head dims
# off them (12 padded to a multiple of 8; 192, 256 and 384 split over CTAs),
# and lengths past 256 at narrow H D up to L H D = 262,144 (2 x 64 at
# L 2048) and past it
ROUTE_SHAPES = ([(256, 16, 64), (257, 16, 64), (300, 8, 64), (512, 8, 64), (513, 8, 64),
                 (200, 8, 32), (200, 4, 128), (152, 32, 32), (152, 8, 128), (759, 32, 32),
                 (759, 8, 128), (256, 8, 128), (257, 8, 128), (2500, 8, 128), (152, 4, 96),
                 (759, 4, 96), (320, 8, 96), (759, 8, 96), (152, 32, 12), (759, 32, 12)]
                + [(L, H, D) for D, H in ((12, 32), (16, 8), (40, 16), (48, 8), (96, 4),
                                          (192, 2), (256, 1), (384, 1))
                   for L in (1, 65, 152, 256, 257, 682, 683)]
                + [(L, 2, 64) for L in (257, 320, 512, 1024, 2047, 2048, 2049)]
                + [(L, 1, 128) for L in (1025, 2048, 2049)])


@pytest.mark.parametrize("L,H,D", ROUTE_SHAPES)
def test_attention_route_pins_the_jax_gate(L, H, D):
    jax_fused, jax_long = jfused_fits(L, H, D), jlong_fits(L, H, D)
    # the route is the JAX gate's, the same on every device, and never
    # raises: K9/K10 wherever fused_attention_fits holds, K7 elsewhere (K7
    # also where the JAX package itself leaves both gates for XLA)
    assert fa.attention_route(L, H, D) == ("fused" if jax_fused else "long")
    # wherever the JAX package runs a Pallas attention, the port runs a
    # kernel: the fused kernels take every shape of its gate (the resident
    # ones where they hold a head, the streamed ones elsewhere), K7 any
    if jax_fused:
        assert fa.resident(L, D) == (D in (32, 64, 128) and L <= 256)
    assert jax_fused or jax_long or (H * D) % 128


def test_training_refuses_attention_beyond_the_kernels():
    """nothing refuses: every window trains, through the same route. Past
    the JAX gate (16 x 64 heads at L 300: L H D 307,200; 8 x 64 at L 513)
    the long attention takes the forward and the backward (autograd of the
    plain version here, the streamed forward and the long attention
    backward on the card), as the JAX package differentiates its long
    attention; inside it (8 x 64 at L 300, 4 x 96 at L 152, ...) the fused
    attention's K9/K10"""
    from osu_dreamer_tpu_torch.models.diffusion import fit
    from osu_dreamer_tpu_torch.ops.long_attention import long_flash_attention

    assert not hasattr(fit, "check_attention_shape")
    for L, H, D in ((300, 8, 64), (152, 16, 64), (152, 8, 128), (152, 32, 32), (152, 4, 96),
                    (320, 8, 96), (512, 8, 64), (152, 32, 12)):
        assert fa.attention_route(L, H, D) == "fused", (L, H, D)
    for L, H, D in ((300, 16, 64), (513, 8, 64)):
        assert fa.attention_route(L, H, D) == "long", (L, H, D)
        q, k, v = (torch.randn(1, L, H, D, generator=torch.Generator().manual_seed(i),
                               requires_grad=True) for i in range(3))
        grads = torch.autograd.grad(long_flash_attention(q, k, v).square().sum(), (q, k, v))
        assert all(g.shape == (1, L, H, D) and bool(torch.isfinite(g).all()) for g in grads)


def _jax_swiglu_fwd_pallas(C: int, H: int) -> bool:
    """the JAX SwiGLU's auto policy (C % 128) and its forward tile budget"""
    tile = shrink_tile_to_budget(lambda t: jsw._fwd_vmem_bytes(C, H, K, t), jsw.DEFAULT_TILE)
    return C % 128 == 0 and tile is not None


def _jax_swiglu_bwd(C: int, H: int) -> str:
    """the JAX ``_bwd``'s choice"""
    if jsw._feasible_bwd_tile(C, H, K, jsw.DEFAULT_TILE) is not None:
        return "full"
    if jsw._feasible_partial_tile(C, H, K, jsw.DEFAULT_TILE) is not None:
        return "partial"
    return "plain"


@pytest.mark.parametrize("C", WIDTHS)
def test_swiglu_route_pins_the_jax_dispatch(C):
    H = _hidden(C)
    if _jax_swiglu_fwd_pallas(C, H):
        assert sw.fwd_kernel_fits(C, K, H)
    route = sw.bwd_route(C, H, K)
    assert route == _jax_swiglu_bwd(C, H)
    # the kernel the route names takes the width (csrc/swiglu_bwd.cu)
    if route == "full":
        assert C % 32 == 0 and C <= 512
    if route == "partial":
        assert C % 32 == 0 and C <= 640 and sw.bwd_rows(C) in (80, 48)


@pytest.mark.parametrize("C", WIDTHS)
def test_film_layer_route_pins_the_jax_dispatch(C):
    H = _hidden(C)
    jax_fused = (C % 128 == 0 and jfl.feasible_tile(C, H, K) is not None
                 and jfl.feasible_fwd_tile(C, H, K) is not None)
    if jax_fused:
        assert sw.fwd_kernel_fits(C, K, H)
        assert fl.bwd_kernel_fits(C, K)
    if fl.bwd_kernel_fits(C, K):
        assert C in fl.BWD_WIDTHS


@pytest.mark.parametrize("C", WIDTHS)
def test_prologue_route_pins_the_jax_gate(C, monkeypatch):
    """the JAX ``_prologue_ok`` at every width; on a tensor-parallel model
    group the same rule on every rank's share of the heads, one route for
    the whole group (where the JAX gate is off under GSPMD, the port's
    ranks run the TP forms of K11 and K12)"""
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    for F in range(384, 8065, 384):
        jax_ok = (C % 128 == 0 and F % 128 == 0 and jfq.feasible_fwd_tile(C, F) is not None
                  and jfq.feasible_bwd_tile(C, F) is not None)
        assert prologue_ok(C, F) == jax_ok, (C, F)
        if jax_ok:  # K11 and K12 take the shape (csrc/film_qkv.cu)
            assert C % 64 == 0 and C <= fq.MAX_C and F % 128 == 0
    for heads, D in ((16, 64), (8, 128), (12, 64), (32, 32)):
        for tp in (1, 2, 3, 4):
            shares = [hi - lo for lo, hi in (even_split(heads, tp, r) for r in range(tp))]
            assert prologue_tp_ok(C, heads, D, tp) == all(
                prologue_ok(C, 3 * n * D) for n in shares), (heads, D, tp)
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "0")
    assert not prologue_ok(C, 3072)
    assert not prologue_tp_ok(C, 16, 64, 2)


@pytest.mark.parametrize("C", WIDTHS + [144, 200])
@pytest.mark.parametrize("tp", [2, 3])
def test_tp_routes_follow_the_one_rank_routes(C, tp):
    """a tensor-parallel slice is routed as the one-rank op, never refused:
    the SwiGLU TP forms run the K4 TP form where the forward core takes the
    largest slice (where it takes the whole H too), then the backward
    ``bwd_route`` names (K5's TP form at the widths whose one-rank backward
    is K5); the film layer's K2 TP form likewise, then K3's where
    ``bwd_kernel_fits``; the plain versions elsewhere and on the CPU"""
    H = _hidden(C)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    hp_max = sw.tp_hidden_pads(H, tp)[1]
    fwd = "kernel" if sw.fwd_kernel_fits(C, K, hp_max) else "plain"
    if sw.fwd_kernel_fits(C, K, H):
        assert fwd == "kernel"
    want = (fwd, sw.bwd_route(C, H, K) if fwd == "kernel" else "plain")
    assert sw.swiglu_tp_route(C, K, H, tp, cuda) == want
    assert sw.swiglu_tp_route(C, K, H, tp, cpu) == ("plain", "plain")
    film_bwd = "kernel" if fwd == "kernel" and fl.bwd_kernel_fits(C, K) else "plain"
    assert fl.film_layer_tp_route(C, K, H, tp, cuda) == (fwd, film_bwd)
    assert fl.film_layer_tp_route(C, K, H, tp, cpu) == ("plain", "plain")
    if C == 384:  # the width-384 denoiser: K5 one-rank, so K5's TP form
        assert want == ("kernel", "full")
    if C == 144:  # C % 32 != 0: the one-rank backward is the plain version
        assert want == ("kernel", "plain")
