"""Each CUDA kernel of the port against its plain PyTorch version on an
NVIDIA card (skipped where torch.cuda.is_available() is false). Run on the
card with ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``; this
file imports nothing of JAX.

Small ragged shapes; bf16 kernels are held to 4 ulp of the output's largest
magnitude (they round where the plain versions round, but accumulate their
products in another order, so an intermediate bf16 rounding can flip and pass
through the next projection); the f32 resonator to 1e-5 absolute.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.ops import film_layer, long_attention, resonator, swiglu

BF16_ULPS = 4


def _case(kernel: str, dev: str):
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    C, H = 64, 40
    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]
    x = rnd(2, 45, C)
    if kernel == "swiglu":
        return swiglu.swiglu_cuda, swiglu.swiglu_plain, (x, *w)
    if kernel == "film_layer":
        film = [rnd(2, C, scale=0.3) for _ in range(3)] + [1 + rnd(C, scale=0.1)] * 2
        return film_layer.film_layer_cuda, film_layer.film_layer_plain, (x, *film, *w)
    if kernel == "flash_attention":
        qkv = tuple(rnd(2, 77, 3, 64) for _ in range(3))
        return long_attention.attention_cuda, long_attention.attention_plain, qkv
    frames = rnd(2, 150, 98, scale=0.3, dtype=torch.float32)
    return resonator.resonate_cuda, resonator.resonate_plain, (frames,)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["swiglu", "film_layer", "flash_attention", "resonator"])
def test_kernel_matches_plain_on_gpu(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    cuda_fn, plain_fn, args = _case(kernel, "cuda")
    got, want = cuda_fn(*args).float(), plain_fn(*args).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if kernel == "resonator":
        tol = 1e-5
    else:
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol
