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

from osu_dreamer_tpu.ops import film_layer as jfl
from osu_dreamer_tpu.ops import film_qkv as jfq
from osu_dreamer_tpu.ops import swiglu as jsw
from osu_dreamer_tpu.ops._tiles import shrink_tile_to_budget
from osu_dreamer_tpu.ops.fused_attention import fused_attention_fits as jfused_fits
from osu_dreamer_tpu.ops.long_attention import long_attention_fits as jlong_fits
from osu_dreamer_tpu_torch.models.diffusion.fit import check_attention_shape
from osu_dreamer_tpu_torch.nn.attention import prologue_ok
from osu_dreamer_tpu_torch.ops import film_layer as fl
from osu_dreamer_tpu_torch.ops import film_qkv as fq
from osu_dreamer_tpu_torch.ops import fused_attention as fa
from osu_dreamer_tpu_torch.ops import swiglu as sw
from osu_dreamer_tpu_torch.ops.long_attention import HEAD_DIMS

WIDTHS = [64, 128, 256, 384, 512, 640, 768, 1024]
K = 5


def _hidden(C: int) -> int:
    return int(C * 4 * 2 / 3)


@pytest.mark.parametrize("L,H,D", [(256, 16, 64), (257, 16, 64), (300, 8, 64), (512, 8, 64),
                                   (200, 8, 32), (200, 4, 128), (152, 32, 32), (152, 8, 128),
                                   (759, 32, 32), (759, 8, 128), (256, 8, 128), (257, 8, 128),
                                   (2500, 8, 128), (152, 4, 96), (759, 4, 96)])
def test_attention_route_pins_the_jax_gate(L, H, D):
    jax_fused, jax_long = jfused_fits(L, H, D), jlong_fits(L, H, D)
    # off the card the JAX gate alone decides, as before
    assert fa.attention_route(L, H, D, "cpu") == ("fused" if jax_fused else "long")
    if D not in HEAD_DIMS:
        # every attention kernel takes head dims 32, 64 and 128: the route
        # names any other dim before a launch
        with pytest.raises(ValueError, match=f"head dim {D}"):
            fa.attention_route(L, H, D, "cuda")
        return
    route = fa.attention_route(L, H, D, "cuda")
    # K9/K10 only where the JAX gate holds AND their shared memory takes L
    assert (route == "fused") == (jax_fused and L <= fa.MAX_KERNEL_LEN)
    # the long route is K7, which takes these head dims at any L: wherever
    # the JAX package runs a Pallas attention, the port runs a kernel too
    assert jax_fused or jax_long
    assert route in ("fused", "long")


def test_training_refuses_attention_beyond_the_kernels():
    """fit.run's check, through the same route: 8 x 64 heads at L 300 pass
    the JAX gate but not K9/K10's range, so training on the card refuses
    before step 1 with the shape named; on the CPU the plain backward serves"""
    with pytest.raises(NotImplementedError, match="seq_len 300 with 8 x 64 heads"):
        check_attention_shape(300, 8, 64, "cuda")
    check_attention_shape(300, 8, 64, "cpu")
    check_attention_shape(152, 16, 64, "cuda")
    check_attention_shape(152, 8, 128, "cuda")
    check_attention_shape(152, 32, 32, "cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        check_attention_shape(152, 4, 96, "cuda")


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
    """the JAX ``_prologue_ok`` at every width, and off on a tensor-parallel
    rank (``sharded``) as the JAX gate is under GSPMD"""
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    for F in range(384, 8065, 384):
        jax_ok = (C % 128 == 0 and F % 128 == 0 and jfq.feasible_fwd_tile(C, F) is not None
                  and jfq.feasible_bwd_tile(C, F) is not None)
        assert prologue_ok(C, F) == jax_ok, (C, F)
        assert not prologue_ok(C, F, sharded=True)
        if jax_ok:  # K11 and K12 take the shape (csrc/film_qkv.cu)
            assert C % 64 == 0 and C <= fq.MAX_C and F % 128 == 0
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "0")
    assert not prologue_ok(C, 3072)
