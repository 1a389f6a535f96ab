"""SwiGLU conv-FFN forward and backward: the plain PyTorch versions and the
CUDA kernels.

Counterpart of osu_dreamer_tpu/ops/swiglu.py (``swiglu_reference``, the
Pallas forward ``_kernel``, the full backward ``_bwd_kernel`` and the partial
backward ``_partial_bwd_kernel``). The block is

    x -> depthwise conv (2r+1 taps, zero SAME padding) -> (C, 2H) projection
      -> v * silu(g) -> RMS norm over H (f32 statistics) -> (H, C) projection

``swiglu`` dispatches by device and decides the route before any launch. A
CUDA tensor whose width the forward kernel takes (``fwd_kernel_fits``) goes to
a ``torch.autograd.Function`` whose forward is the kernel in
``csrc/swiglu.cu`` (K4, on the core of ``csrc/ffn_core.cuh``) and whose
backward follows the JAX ``_bwd`` (``bwd_route``): where
``bwd_kernel_feasible`` holds, ``odt_swiglu_bwd_full`` in
``csrc/swiglu_bwd.cu`` (K5, every weight gradient in the call); where the
JAX partial backward fits, ``odt_swiglu_bwd`` (K6) plus the two big weight
products as torch matmuls; elsewhere autograd of ``swiglu_plain``, the JAX
package's own reference vjp at those widths. K5 and K6 run on the backward
core of ``csrc/ffn_bwd_core.cuh`` (as does the film layer's K3). Any other
CUDA input runs ``swiglu_plain`` on the card, and a CPU tensor
``swiglu_plain``, both differentiated by autograd.

The kernels read the weights in one packed layout, built once per weight
version (``packed_ffn_weights``): a cache keyed on the weight tensors and
their in-place version counters, so an optimizer step (which updates the
parameters in place) forces a repack. The forward and backward cores read
the same pack, so a training step holds one pack a layer.

Tensor parallelism (``swiglu_tp``, parallel/tp.py): a rank holds a slice of
the hidden units. ``SwiGLUTPFunction`` runs the TP forms: the forward (the
slice's f32 partial s W_out and row sums of s^2, ``swiglu_tp_partial``; their
sum over the model group; ``swiglu_tp_finish``: 1 / rms over the whole
hidden width, b_out once) and the backward (``swiglu_tp_bwd``: the
forward's summed partials give n and m, the slice gives its dY partial and
weight gradients; the dY sum over the model group; the finish: the
transposed conv, dx and the conv and out-bias gradients, equal on every
rank). A slice is routed as the one-rank op (``swiglu_tp_route``): on the
card the K4 TP form where the forward core takes the largest slice, its
backward as ``bwd_route`` names it (K5's TP form, K6's, or the plain
version); elsewhere, and on the CPU, the plain versions of the forms.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..nn.norm import rms_norm
from ..parallel.collectives import group_size, tp_all_reduce_
from ._build import check_cuda, library, run

# the row chunks of csrc/gemm_tn.cuh's weight products: about one (128 x 128
# output tile, chunk) item for each of the H100's 132 SMs
_GEMM_ITEMS = 132
# csrc/ffn_core.cuh: the most ring stages, their bytes, the shared memory
# beside y and the ring, the largest conv radius (tests/test_torch_ffn_core.py
# reads them from the header and holds these copies to them)
_FC_MAX_STAGES, _FC_STAGE_BYTES, _FC_EXTRA_BYTES, _FC_MAX_RADIUS = 8, 18 * 1024, 2176, 4
_MAX_SMEM = 232448  # shared memory a block may use on Hopper (csrc/common.cuh kMaxSmem)
# csrc/ffn_bwd_core.cuh: pass B's ring stages (the most, their bytes), the dY
# columns a warpgroup of its own rows holds, the C past which and up to which
# the paired mode runs (two warpgroups on one row tile), the rows of the row
# kernels' CTAs (held to the header by tests/test_torch_ffn_bwd_core.py)
_BG_MAX_STAGES, _BG_STAGE_BYTES, _BG_COLS, _BM_ROWS = 6, 24 * 1024, 128, 32
_BP_FROM, _BP_COLS = 384, 512

# The JAX dispatch rules of the backward, copied from
# osu_dreamer_tpu/ops/swiglu.py (``_bwd_vmem_bytes``,
# ``_partial_bwd_vmem_bytes``) and ops/_tiles.py (the budget and the halving
# search), so both packages choose the same backward at the same dims. They
# are the rules that choose a route, not tile sizes of the CUDA kernels.
_HALO = 8
_DEFAULT_TILE = 512
_VMEM_BUDGET_BYTES = 14 * 2**20


def shrink_tile_to_budget(vmem_bytes, tile: int, min_tile: int = 64) -> int | None:
    """ops/_tiles.py: the largest power-of-two shrink of ``tile`` whose
    footprint fits the budget, or None"""
    while tile > min_tile and vmem_bytes(tile) > _VMEM_BUDGET_BYTES:
        tile //= 2
    return tile if vmem_bytes(tile) <= _VMEM_BUDGET_BYTES else None


def _bwd_vmem_bytes(C: int, H: int, K: int, tile: int) -> int:
    E = tile + 2 * _HALO
    weights = 2 * (K * C + C + C * 2 * H + 2 * H + H * C)
    accums = 4 * (K * C + C + C * 2 * H + 2 * H + H * C + C)
    work = 4 * E * (2 * H) * 3 + 4 * E * H * 2 + 4 * E * C * 2 + 2 * E * C * 2
    return weights + accums + work


def _partial_bwd_vmem_bytes(C: int, H: int, K: int, tile: int) -> int:
    E = tile + 2 * _HALO
    weights = 2 * (K * C + C + C * 2 * H + 2 * H + H * C)
    accums = 4 * (K * C + C + 2 * H + C)
    work = 4 * E * (2 * H) * 2 + 4 * E * H * 3 + 4 * E * C * 2 + 2 * E * C * 2
    emit = 2 * tile * (2 * H + H + C) * 2
    return weights + accums + work + emit


def bwd_kernel_feasible(C: int, H: int, K: int) -> bool:
    """whether the JAX package takes its full-accumulator backward at these
    dims"""
    return shrink_tile_to_budget(lambda t: _bwd_vmem_bytes(C, H, K, t), _DEFAULT_TILE) is not None


def partial_bwd_feasible(C: int, H: int, K: int) -> bool:
    """whether the JAX package's partial backward fits (``_feasible_partial_tile``)"""
    return shrink_tile_to_budget(
        lambda t: _partial_bwd_vmem_bytes(C, H, K, t), _DEFAULT_TILE) is not None


def bwd_rows(C: int) -> int:
    """rows of one batch row a CTA of the SwiGLU backward's finish (the
    transposed conv and the column partials, csrc/ffn_bwd_core.cuh
    ``bwd_finish_plain_kernel``): 80, or 48 past C 512; its halo costs
    2r / rows of re-reads. Pass B's tiles are 64 flat rows (``bwd_plan``)."""
    return 80 if C <= 512 else 48


def bwd_route(C: int, H: int, K: int) -> str:
    """the SwiGLU backward on the card, as the JAX ``_bwd`` chooses it:
    "full" (K5) where ``bwd_kernel_feasible``, "partial" (K6) where the
    partial backward fits, else "plain" (autograd of ``swiglu_plain``, the
    JAX reference vjp). K5 takes C % 32 == 0 up to 512, K6 up to 640."""
    fits = C % 32 == 0 and K % 2 == 1 and K <= 9
    if fits and C <= 512 and bwd_kernel_feasible(C, H, K):
        return "full"
    if fits and C <= 640 and partial_bwd_feasible(C, H, K):
        return "partial"
    return "plain"


def fwd_stages(C: int, K: int, H: int) -> int:
    """ring stages of csrc/ffn_core.cuh's kernel (``ffn_stages``) at its
    largest: as many 18 KB stages as fit beside the y tiles and the vectors
    of the film layer's CTA holding the whole hidden dimension, at most 8"""
    nwg = 2 if C <= 512 else 1
    nloc = -(-H // 64)
    params = 2 * nloc * 64 * 4 + C * 4 + K * C * 2 + C * 2 + 2 * C * 2
    fixed = -(-C // 64) * nwg * 8192 + -(-params // 1024) * 1024 + _FC_EXTRA_BYTES
    return max(0, min(_FC_MAX_STAGES, (_MAX_SMEM - fixed) // _FC_STAGE_BYTES))


def fwd_kernel_fits(C: int, K: int, H: int) -> bool:
    """whether the forward core (K4, K2) takes width C, K taps and hidden
    width H: C a multiple of 16 (padded to 64-column boxes inside the kernel)
    whose y tiles and vectors leave room for two ring stages"""
    return C % 16 == 0 and K % 2 == 1 and K // 2 <= _FC_MAX_RADIUS and fwd_stages(C, K, H) >= 2


def fwd_plan(rows: int, C: int, Hp: int, sms: int, film: bool = False) -> tuple[int, int]:
    """(output columns a CTA holds, hidden slices) of the forward core over
    ``rows`` = B L positions on a card of ``sms`` SMs: 256 columns (128
    registers a thread) where C allows, else 128 (always for the film layer,
    whose epilogue keeps more in registers); the hidden dimension split
    across CTAs until the row tiles and column groups fill the SMs"""
    nc = 256 if C % 256 == 0 and not film else 128
    tile = 128 if C <= 512 else 64
    ctas = -(-rows // tile) * -(-C // nc)
    slices = 1 if ctas >= sms else max(1, min(Hp // 64, sms // ctas))
    return nc, slices


def bwd_plan(rows: int, C: int, Hp: int, sms: int, film: bool) -> tuple[int, int, int]:
    """(row warpgroups a CTA, hidden slices of pass A, hidden slices of
    pass B) of the backward core (csrc/ffn_bwd_core.cuh; ``film`` for K3)
    over ``rows`` = B L positions on a card of ``sms`` SMs. Up to C 384
    and at C 640 pass B runs 128-column groups across CTAs; a CTA takes two
    64-row warpgroups up to C 256 where 128-row tiles fill the card, else
    one (more CTAs for short inputs, and room for wider y and do tiles).
    From C 416 to 512 a CTA takes one 64-row tile and pass B pairs two
    warpgroups on it, splitting the dY columns. Then each pass's hidden
    dimension splits across CTAs until its grid (row tiles x column groups
    x slices) fills the card, as far as the 64-column hidden chunks allow"""
    nch = Hp // 64
    groups_b = 1 if _BP_FROM < C <= _BP_COLS else -(-C // _BG_COLS)
    nwg = 2 if C <= 256 and -(-rows // 128) * groups_b >= sms else 1
    tiles = -(-rows // (64 * nwg))

    def slices(groups: int) -> int:
        ctas = tiles * groups
        return 1 if ctas >= sms else min(nch, -(-sms // ctas))

    # pass A: K3's is the forward core (128 output columns a CTA), K6's the
    # statistics pass (no output columns)
    return nwg, slices(-(-C // 128) if film else 1), slices(groups_b)


def bwd_stages(C: int, rw: int, pair: bool, nloc: int) -> int:
    """ring stages of the backward core's pass B or K6's statistics pass
    (``bwd_stages`` of csrc/ffn_bwd_core.cuh): as many 24 KB stages as fit
    beside the y and do tiles of ``rw`` 64-row warpgroups, the paired mode's
    two dvg tiles or else the vg biases of ``nloc`` hidden chunks, and the
    column sums, at most 6"""
    dos = -(-C // 64) * rw * 8192
    total = (2 * dos + int(pair) * 2 * 8192 + (1 - int(pair)) * 2 * nloc * 64 * 4
             + (rw + int(pair)) * 2 * 4 * 128 * 4 + (2 * _BG_MAX_STAGES + 1) * 8 + 1024)
    return max(0, min(_BG_MAX_STAGES, (_MAX_SMEM - total) // _BG_STAGE_BYTES))


@functools.cache
def device_sms(device: torch.device) -> int:
    """the streaming multiprocessors of a CUDA device (csrc/ffn_core.cuh
    sizes its grid from the same count)"""
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemm_splits(rows: int, m: int, n: int) -> int:
    """row chunks of csrc/gemm_tn.cuh for a (m, n) product over ``rows``
    rows (at most one per 64 rows): the size of its partials"""
    tiles = -(-m // 128) * -(-n // 128)
    return max(1, min(-(-rows // 64), -(-_GEMM_ITEMS // tiles)))


def depthwise_conv(x: torch.Tensor, dw_kernel: torch.Tensor, dw_bias: torch.Tensor
                   ) -> torch.Tensor:
    """the block's (2r+1)-tap depthwise conv, zero SAME padding, in x's dtype"""
    dt = x.dtype
    K, L = dw_kernel.shape[0], x.shape[1]
    r = K // 2
    xp = F.pad(x, (0, 0, r, r))
    return sum(xp[:, k : k + L] * dw_kernel[k].to(dt) for k in range(K)) + dw_bias.to(dt)


def swiglu_plain(
    x: torch.Tensor,            # (B, L, C)
    dw_kernel: torch.Tensor,    # (K, C)
    dw_bias: torch.Tensor,      # (C,)
    vg_kernel: torch.Tensor,    # (C, 2H)
    vg_bias: torch.Tensor,      # (2H,)
    out_kernel: torch.Tensor,   # (H, C)
    out_bias: torch.Tensor,     # (C,)
) -> torch.Tensor:
    """every op in x's dtype, in the JAX reference's order"""
    dt = x.dtype
    y = depthwise_conv(x, dw_kernel, dw_bias)
    vg = y @ vg_kernel.to(dt) + vg_bias.to(dt)
    v, g = vg.chunk(2, dim=-1)
    h = rms_norm(v * F.silu(g))
    return h @ out_kernel.to(dt) + out_bias.to(dt)


# ---------------------------------------------------------------- packs ----

# the packed layouts live as long as the W_vg tensor they were made from:
# W_vg -> {(kind, dtype): (weak references to all the weight tensors, their
# in-place versions, the layout)}
_PACKS = WeakIdKeyDictionary()


def _cached(kind: str, tensors: tuple[torch.Tensor, ...], dtype: torch.dtype, make,
            owner: torch.Tensor | None = None):
    """``make()`` once per version of ``tensors``, kept as long as ``owner``
    (by default their third, W_vg) lives: a hit needs the same tensor
    objects at the same in-place versions. Inference tensors keep no version
    counter and are packed anew. A layout keeps no autograd history (which
    would hold the weights alive)."""
    if any(t.is_inference() for t in tensors):
        with torch.no_grad():
            return make()
    versions = tuple(t._version for t in tensors)
    packs = _PACKS.setdefault(tensors[2] if owner is None else owner, {})
    hit = packs.get((kind, dtype))
    if hit is not None and hit[1] == versions and all(
            ref() is t for ref, t in zip(hit[0], tensors)):
        return hit[2]
    with torch.no_grad():
        packed = make()
    packs[(kind, dtype)] = (tuple(weakref.ref(t) for t in tensors), versions, packed)
    return packed


@dataclass
class FfnPack:
    """the weights of the forward and backward cores (csrc/ffn_core.cuh,
    csrc/ffn_bwd_core.cuh): W_vg^T (2 Hp, C) and W_out^T (C, Hp) in
    ``dtype``, K-major, H zero-padded to Hp (a multiple of 64, so the g half
    starts on a 16-byte TMA boundary); b_vg as f32 holding ``dtype`` values;
    the weights' tensor maps once encoded on the card"""

    dww: torch.Tensor
    dwb: torch.Tensor
    wvg_t: torch.Tensor
    wout_t: torch.Tensor
    bvg: torch.Tensor
    H: int
    Hp: int
    maps: ctypes.Array | None = None

    def weight_maps(self) -> int:
        """host address of the two CUtensorMaps (encoded at first use)"""
        if self.maps is None:
            maps = (ctypes.c_uint8 * 256)()
            err = library().odt_ffn_weight_maps(self.wvg_t.data_ptr(), self.wout_t.data_ptr(),
                                                self.wout_t.shape[0], self.Hp, ctypes.addressof(maps))
            if err != 0:
                raise RuntimeError(f"ffn weight tensor maps: cudaError {err}")
            self.maps = maps
        return ctypes.addressof(self.maps)


def pack_ffn(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, dtype: torch.dtype) -> FfnPack:
    """the cores' layout of the SwiGLU weights (uncached)"""
    C, H2 = vg_kernel.shape
    H = H2 // 2
    Hp = -(-H // 64) * 64
    dev = vg_kernel.device
    wvg_t = torch.zeros(2 * Hp, C, dtype=dtype, device=dev)
    wvg_t[:H] = vg_kernel[:, :H].t()
    wvg_t[Hp : Hp + H] = vg_kernel[:, H:].t()
    wout_t = torch.zeros(C, Hp, dtype=dtype, device=dev)
    wout_t[:, :H] = out_kernel.t()
    bvg = torch.zeros(2 * Hp, dtype=torch.float32, device=dev)
    bvg[:H] = vg_bias[:H].to(dtype)
    bvg[Hp : Hp + H] = vg_bias[H:].to(dtype)
    return FfnPack(dw_kernel.to(dtype).contiguous(), dw_bias.to(dtype).contiguous(), wvg_t,
                   wout_t, bvg, H, Hp)


def packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                       dtype: torch.dtype) -> FfnPack:
    """``pack_ffn``, once per weight version"""
    weights = (dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)
    return _cached("ffn", weights, dtype, lambda: pack_ffn(*weights, dtype))


def packed_out_bias(out_bias, vg_kernel, dtype: torch.dtype) -> torch.Tensor:
    """b_out in ``dtype``, once per version of ``out_bias`` (kept beside
    W_vg's pack, apart from it: the backward reads the pack and no b_out)"""
    return _cached("bout", (out_bias,), dtype, lambda: out_bias.to(dtype).contiguous(),
                   owner=vg_kernel)


def check_ffn_shapes(x: torch.Tensor, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     out_bias) -> None:
    """raise unless the SwiGLU weights fit (B, L, C) input x as the kernels
    read them"""
    C = x.shape[-1]
    K, H = dw_kernel.shape[0], out_kernel.shape[0]
    if C % 16:
        raise ValueError(f"channels {C} must be a multiple of 16")
    if K % 2 == 0:
        raise ValueError(f"depthwise width {K} must be odd")
    shapes = {"dw_kernel": (dw_kernel, (K, C)), "dw_bias": (dw_bias, (C,)),
              "vg_kernel": (vg_kernel, (C, 2 * H)), "vg_bias": (vg_bias, (2 * H,)),
              "out_kernel": (out_kernel, (H, C)), "out_bias": (out_bias, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the input on {x.device}")


def ffn_fwd_inputs(x, weights, film: bool = False) -> tuple[FfnPack, int, int, tuple]:
    """the forward core's checks and operands: -> (pack, output columns a
    CTA holds, hidden slices, (workspace, sums of squares), None where one
    CTA owns a row tile)"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, *weights)
    B, L, C = x.shape
    K, H = weights[0].shape[0], weights[4].shape[0]
    if not fwd_kernel_fits(C, K, H):
        raise ValueError(f"channels {C} / {K} taps outside the forward kernel's range (C a "
                         f"multiple of 16 up to the shared-memory limit, radius <= {_FC_MAX_RADIUS})")
    pack = packed_ffn_weights(*weights[:5], x.dtype)
    nc, slices = fwd_plan(B * L, C, pack.Hp, device_sms(x.device), film)
    if slices == 1 and C <= nc:
        return pack, nc, slices, (None, None)
    f32 = dict(dtype=torch.float32, device=x.device)
    ws, ss = torch.empty(slices, B * L, C, **f32), torch.empty(slices, B * L, **f32)
    return pack, nc, slices, (ws, ss)


def swiglu_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias) -> torch.Tensor:
    """K4, csrc/swiglu.cu: bf16 (B, L, C) -> (B, L, C)"""
    pack, nc, slices, scratch = ffn_fwd_inputs(
        x, (dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias))
    B, L, C = x.shape
    out, bout = torch.empty_like(x), packed_out_bias(out_bias, vg_kernel, x.dtype)
    run(
        "odt_swiglu_fwd", "swiglu", x.device,
        x.data_ptr(), pack.dww.data_ptr(), pack.dwb.data_ptr(), pack.bvg.data_ptr(),
        bout.data_ptr(), pack.weight_maps(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        B, L, C, pack.H, pack.Hp, dw_kernel.shape[0], slices, nc,
    )
    return out


def swiglu_bwd_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """autograd of ``swiglu_plain`` -> (dx, d dw_kernel, d dw_bias,
    d vg_kernel, d vg_bias, d out_kernel, d out_bias), the tuple the JAX
    ``_fused_swiglu_partial_bwd_impl`` returns"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)]
        out_bias = out_kernel.new_zeros(out_kernel.shape[1]).requires_grad_()
        y = swiglu_plain(*leaves, out_bias)
        return torch.autograd.grad(y, [*leaves, out_bias], grad_out)


def _bwd_core(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, full: bool):
    """K6 (``full`` False) or K5 on the backward core: -> (dx, the small
    gradients, H, Hp, and K6's y, dvg, hn and bf16 output gradient for the
    weight products, or K5's padded dW_vg and dW_out)"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     vg_kernel.new_empty(x.shape[-1]))  # the kernels read no output bias
    go = grad_out.to(torch.bfloat16).contiguous()
    B, L, C = x.shape
    max_c = 512 if full else 640
    if C % 32 or C > max_c:
        raise ValueError(f"channels {C} must be a multiple of 32 and at most {max_c} "
                         "for this backward kernel")
    if go.shape != x.shape or go.device != x.device:
        raise ValueError(f"grad_out must be {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(go.shape)} on {go.device}")
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    K, H, Hp, BL, dev = dw_kernel.shape[0], pack.H, pack.Hp, B * L, x.device
    nwg, sa, sb = bwd_plan(BL, C, Hp, device_sms(dev), film=False)
    frows = bwd_rows(C)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    work = [torch.empty(2 * sa, BL, **f32),                           # pass A: sum s^2, sum dhn s
            torch.empty(BL, C, **bf), torch.empty(BL, 2, **f32),      # y, (n, n^3 m)
            torch.empty(BL, 2 * Hp, **bf), torch.empty(BL, Hp, **bf),  # dvg, hn
            torch.empty(-(-BL // (64 * nwg)) * nwg, 2 * Hp, **f32),   # vg-bias partials
            torch.empty(sb, BL, C, **f32),                             # dY
            torch.empty(B, -(-L // frows), 2 + K, C, **f32)]           # the finish's sums
    args = [x.data_ptr(), go.data_ptr(), pack.dww.data_ptr(), pack.dwb.data_ptr(),
            pack.bvg.data_ptr(), pack.weight_maps(), dx.data_ptr(), *(t.data_ptr() for t in work)]
    dims = [B, L, C, H, Hp, K, nwg, sa, sb, frows]
    if full:
        s_vg, s_out = gemm_splits(BL, C, 2 * Hp), gemm_splits(BL, Hp, C)
        prods = [torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32),
                 torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)]
        run("odt_swiglu_bwd_full", "swiglu_bwd_full", dev, *args, *(t.data_ptr() for t in prods),
            *dims, s_vg, s_out)
        extra = prods[2:]
    else:
        run("odt_swiglu_bwd", "swiglu_bwd", dev, *args, *dims)
        extra = [work[1], work[3], work[4], go.reshape(BL, C)]
    fin, dbvg = work[7].sum((0, 1)), work[5].sum(0)  # d dw_bias, d out_bias, the taps
    small = (fin[2:], fin[0], torch.cat([dbvg[:H], dbvg[Hp : Hp + H]]), fin[1])
    return dx, small, H, Hp, extra


def swiglu_bwd_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """K6, csrc/swiglu_bwd.cu: dx (bf16) and the small gradients (f32) from
    the backward core; dW_vg = y^T dvg and dW_out = hn^T go as f32-accumulated
    torch matmuls over all B L rows. -> the tuple of ``swiglu_bwd_plain``,
    weight gradients f32"""
    dx, (ddw, ddwb, dbvg, dbout), H, Hp, (y, dvg, hn, go) = _bwd_core(
        x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, full=False)
    dwvg = torch.mm(y.t(), dvg, out_dtype=torch.float32)
    dwout = torch.mm(hn.t(), go, out_dtype=torch.float32)
    return (dx, ddw, ddwb, torch.cat([dwvg[:, :H], dwvg[:, Hp : Hp + H]], 1), dbvg, dwout[:H], dbout)


def swiglu_bwd_full_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """K5, csrc/swiglu_bwd.cu ``odt_swiglu_bwd_full``: K6's pass, then both
    weight products (csrc/gemm_tn.cuh, fixed-order chunk sums) in the same
    call. -> the tuple of ``swiglu_bwd_plain``, dx bf16 and the weight
    gradients f32"""
    dx, (ddw, ddwb, dbvg, dbout), H, Hp, (dwvg, dwout) = _bwd_core(
        x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, full=True)
    return (dx, ddw, ddwb, torch.cat([dwvg[:, :H], dwvg[:, Hp : Hp + H]], 1), dbvg, dwout[:H], dbout)


class SwiGLUFunction(torch.autograd.Function):
    """K4 forward; the backward ``bwd_route`` chooses: K5, K6, or autograd of
    the plain version"""

    @staticmethod
    def forward(ctx, x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias):
        ctx.save_for_backward(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)
        return swiglu_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)

    @staticmethod
    def backward(ctx, grad_out):
        x, *weights = ctx.saved_tensors
        C, H, K = x.shape[-1], weights[4].shape[0], weights[0].shape[0]
        bwd = {"full": swiglu_bwd_full_cuda, "partial": swiglu_bwd_cuda,
               "plain": swiglu_bwd_plain}[bwd_route(C, H, K)]
        grads = bwd(x, *weights, grad_out)
        return (grads[0].to(x.dtype),
                *(g.to(w.dtype) for g, w in zip(grads[1:], (*weights, weights[-1]))))


def swiglu(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias) -> torch.Tensor:
    """SwiGLU: on the card the kernels where ``fwd_kernel_fits`` (the
    backward as ``bwd_route`` decides), elsewhere the plain version; the
    plain version (autograd) for CPU tensors"""
    args = (x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    if x.is_cuda:
        if fwd_kernel_fits(x.shape[-1], dw_kernel.shape[0], out_kernel.shape[0]):
            return SwiGLUFunction.apply(*args)
        return swiglu_plain(*args)
    if x.device.type != "cpu":
        raise ValueError(f"swiglu: no implementation for device {x.device}")
    return swiglu_plain(*args)


# ------------------------------------------------------ tensor parallelism ----

_EPS = 1e-6  # nn/norm.py rms_norm's


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


def tp_hidden_pads(H: int, tp: int) -> tuple[int, int]:
    """(Hp of the smallest slice, Hp of the largest) of H hidden units split
    evenly over tp ranks (parallel/tp.py ``even_split``)"""
    return _pad64(H // tp), _pad64(-(-H // tp))


def tp_fwd_plan(rows: int, C: int, H: int, tp: int, sms: int, film: bool = False
                ) -> tuple[int, int]:
    """(output columns a CTA, hidden slices) of a TP form's forward core, one
    plan on every rank of the model group: the largest slice's, its slices
    no more than the smallest slice has 64-unit chunks (the kernel folds
    them into the one plane the group sums)"""
    hp_min, hp_max = tp_hidden_pads(H, tp)
    nc, slices = fwd_plan(rows, C, hp_max, sms, film)
    return nc, min(slices, hp_min // 64)


def tp_bwd_plan(rows: int, C: int, H: int, tp: int, sms: int, film: bool) -> tuple[int, int]:
    """(row warpgroups a CTA, pass B's hidden slices) of a TP form's backward,
    the same on every rank as ``tp_fwd_plan``"""
    hp_min, hp_max = tp_hidden_pads(H, tp)
    nwg, _, sb = bwd_plan(rows, C, hp_max, sms, film)
    return nwg, min(sb, hp_min // 64)


def swiglu_tp_route(C: int, K: int, H: int, tp: int, device: torch.device) -> tuple[str, str]:
    """(forward, backward) of a TP slice of H hidden units over tp ranks on
    ``device``, as one-rank ``swiglu`` routes: on the card "kernel" (the K4
    TP form) where ``fwd_kernel_fits`` holds at the largest slice's padded
    width, then the backward ``bwd_route`` names ("full": the K5 TP form,
    "partial": K6's, "plain"); else ("plain", "plain"), as on the CPU"""
    if device.type == "cpu":
        return "plain", "plain"
    if device.type != "cuda":
        raise ValueError(f"swiglu_tp: no implementation for device {device}")
    if not fwd_kernel_fits(C, K, tp_hidden_pads(H, tp)[1]):
        return "plain", "plain"
    return "kernel", bwd_route(C, H, K)


def tp_workspace(S: int, rows: int, C: int, device):
    """a TP form's forward workspace of S hidden slices -> (the one plane
    the model group sums, flat f32; the kernel's ws and ss views; the
    plane's pointer where the kernel folds S > 1 slices into it, else
    None: the kernel writes the plane itself)"""
    buf = torch.empty(rows * (C + 1), dtype=torch.float32, device=device)
    if S == 1:
        return (buf, *split_partials(buf, rows, C), None)
    work = torch.empty(S * rows * (C + 1), dtype=torch.float32, device=device)
    return (buf, *split_partials(work, rows, C), buf.data_ptr())


def tp_dy(sb: int, rows: int, C: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """a TP form's backward dY of sb hidden slices -> (the kernel's (sb,
    rows, C) partials, the one plane (1, rows, C) the model group sums: the
    same tensor where sb is 1, else the kernel folds the slices into it)"""
    dy = torch.empty(sb, rows, C, dtype=torch.float32, device=device)
    return dy, dy if sb == 1 else torch.empty(1, rows, C, dtype=torch.float32, device=device)


def split_partials(buf: torch.Tensor, rows: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """a TP form's flat f32 workspace -> its views (S, rows, C) of the
    partial s W_out and (S, rows) of the sums of s^2"""
    S = buf.numel() // (rows * (C + 1))
    return buf[:S * rows * C].view(S, rows, C), buf[S * rows * C:].view(S, rows)


def _slice_products(y, vg_kernel, vg_bias, out_kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """a slice's share of the block from the conv output: (s W_out, f32)
    and (the row sums of s^2, f32), in y's dtype as ``swiglu_plain``"""
    dt = y.dtype
    vg = y @ vg_kernel.to(dt) + vg_bias.to(dt)
    v, g = vg.chunk(2, dim=-1)
    s = v * F.silu(g)
    return (s @ out_kernel.to(dt)).float(), s.float().square().sum(-1)


def tp_partial_plain(y, vg_kernel, vg_bias, out_kernel) -> torch.Tensor:
    """the plain version of a TP form's core from the conv output y: the
    flat workspace of one slice (S 1)"""
    p, ss = _slice_products(y, vg_kernel, vg_bias, out_kernel)
    return torch.cat([p.reshape(-1), ss.reshape(-1)])


def tp_out_plain(buf: torch.Tensor, shape, out_bias, H: int, dtype) -> torch.Tensor:
    """the summed workspace -> o = (s W_out) / rms(s) + b_out in ``dtype``,
    (B, L, C): rms over the whole hidden width H"""
    B, L, C = shape
    ws, ss = split_partials(buf, B * L, C)
    n = torch.rsqrt(ss.sum(0) / H + _EPS)
    return (ws.sum(0) * n[:, None] + out_bias.float()).to(dtype).view(B, L, C)


def grads_of(fn, inputs, grad_out) -> tuple[torch.Tensor, ...]:
    """autograd of ``fn(*inputs)`` with respect to every input"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, grad_out)


def tp_workspace_grads(dbuf: torch.Tensor, rows: int, C: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """the gradient of a summed workspace -> (of the summed s W_out (rows,
    C), of the summed s^2 (rows)): every slice of it carries the same"""
    dws, dss = split_partials(dbuf, rows, C)
    return dws[0], dss[0]


def tp_slice_grads(y, vg_kernel, vg_bias, out_kernel, dP, dSS):
    """the plain version of a TP form's pass B: autograd of the slice's
    products from y -> (dY f32, d vg_kernel, d vg_bias, d out_kernel)"""
    p_shape, ss_shape = y.shape, y.shape[:-1]
    grads = grads_of(lambda *t: _slice_products(*t), (y, vg_kernel, vg_bias, out_kernel),
                     [dP.reshape(p_shape), dSS.reshape(ss_shape)])
    return (grads[0].float(), *grads[1:])


def _tp_route(x, dw_kernel, H: int, tp: int) -> tuple[str, str]:
    return swiglu_tp_route(x.shape[-1], dw_kernel.shape[0], H, tp, x.device)


def swiglu_tp_partial(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, H: int, tp: int
                      ) -> torch.Tensor:
    """the TP form's first phase on this rank's slice (the K4 TP form or its
    plain version, as ``swiglu_tp_route`` says) -> the flat f32 workspace
    (``split_partials``) to sum over the model group"""
    if _tp_route(x, dw_kernel, H, tp)[0] == "kernel":
        return swiglu_tp_partial_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, H, tp)
    return swiglu_tp_partial_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)


def swiglu_tp_partial_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel) -> torch.Tensor:
    """the plain version of the K4 TP form's first phase (one slice, S 1)"""
    return tp_partial_plain(depthwise_conv(x, dw_kernel, dw_bias), vg_kernel, vg_bias, out_kernel)


def swiglu_tp_finish(buf, x, out_bias, H: int, kernel: bool = False) -> torch.Tensor:
    """the TP form's second phase, on the summed workspace -> (B, L, C):
    the K4 TP form's where ``kernel`` (the forward took it), else its plain
    version"""
    if kernel:
        return swiglu_tp_finish_cuda(buf, x, out_bias, H)
    return tp_out_plain(buf, x.shape, out_bias, H, x.dtype)


def swiglu_tp_bwd(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, buf, H: int,
                  tp: int):
    """the TP form's backward first phase (the K5 or K6 TP form or the plain
    version, as ``swiglu_tp_route`` says) -> (this rank's dY partial (1,
    B L, C) f32 to sum over the model group, (d vg_kernel, d vg_bias,
    d out_kernel) of the slice, finish); ``finish()`` on the summed dY ->
    (dx, d dw_kernel, d dw_bias, d out_bias)"""
    route = _tp_route(x, dw_kernel, H, tp)[1]
    if route == "plain":
        return swiglu_tp_bwd_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                                   grad_out, buf, H)
    return swiglu_tp_bwd_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out,
                              buf, H, tp, full=route == "full")


def swiglu_tp_bwd_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, buf,
                        H: int):
    """the plain version of ``swiglu_tp_bwd``: autograd of the finish and
    of the slice's products, then of the conv"""
    B, L, C = x.shape
    zero = out_kernel.new_zeros(C)
    (dbuf,) = grads_of(lambda b: tp_out_plain(b, x.shape, zero, H, x.dtype), (buf,), grad_out)
    dy, *slice_grads = tp_slice_grads(depthwise_conv(x, dw_kernel, dw_bias), vg_kernel, vg_bias,
                                      out_kernel, *tp_workspace_grads(dbuf, B * L, C))
    dy = dy.reshape(1, B * L, C)

    def finish():
        dx, ddw, ddwb = grads_of(depthwise_conv, (x, dw_kernel, dw_bias),
                                 dy.sum(0).view(B, L, C).to(x.dtype))
        return dx, ddw, ddwb, grad_out.float().sum((0, 1))

    return dy, tuple(slice_grads), finish


def swiglu_tp_partial_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, H: int,
                           tp: int) -> torch.Tensor:
    """K4 TP phase 0, csrc/swiglu.cu ``odt_swiglu_fwd_tp``: the core in its
    partial mode over this rank's slice, its hidden slices summed into the
    one plane returned"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     out_kernel.new_empty(x.shape[-1]))
    B, L, C = x.shape
    K = dw_kernel.shape[0]
    if swiglu_tp_route(C, K, H, tp, x.device)[0] != "kernel":
        raise ValueError(f"the K4 TP form does not take C {C}, {K} taps, "
                         f"{tp_hidden_pads(H, tp)[1]} hidden units a rank (fwd_kernel_fits)")
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    nc, S = tp_fwd_plan(B * L, C, H, tp, device_sms(x.device))
    buf, ws, ss, fold = tp_workspace(S, B * L, C, x.device)
    run("odt_swiglu_fwd_tp", "swiglu_tp", x.device,
        x.data_ptr(), pack.dww.data_ptr(), pack.dwb.data_ptr(), pack.bvg.data_ptr(), None,
        pack.weight_maps(), None, ws.data_ptr(), ss.data_ptr(), fold,
        B, L, C, pack.H, pack.Hp, H, K, S, nc, 0)
    return buf


def swiglu_tp_finish_cuda(buf, x, out_bias, H: int) -> torch.Tensor:
    """K4 TP phase 1: the reduction kernel over the summed workspace"""
    B, L, C = x.shape
    ws, ss = split_partials(buf, B * L, C)
    out = torch.empty_like(x)
    bout = out_bias.to(x.dtype).contiguous()
    run("odt_swiglu_fwd_tp", "swiglu_tp", x.device,
        x.data_ptr(), None, None, None, bout.data_ptr(), None, out.data_ptr(), ws.data_ptr(),
        ss.data_ptr(), None, B, L, C, 0, 0, H, 0, ws.shape[0], 0, 1, count=False)
    return out


def swiglu_tp_bwd_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out, buf,
                       H: int, tp: int, full: bool = False):
    """the K6 TP form (``full`` False), csrc/swiglu_bwd.cu ``odt_swiglu_bwd_tp``:
    phase 0 (the conv, the row statistics from the forward's summed
    workspace, pass B on the slice) and the slice's two weight products as
    torch matmuls, as K6; or the K5 TP form, ``odt_swiglu_bwd_full_tp``:
    the same phase 0 and the two products on csrc/gemm_tn.cuh in the same
    call, as K5. ``finish`` runs phase 1 on the summed dY"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     out_kernel.new_empty(x.shape[-1]))
    B, L, C = x.shape
    K, BL, dev = dw_kernel.shape[0], B * L, x.device
    route = swiglu_tp_route(C, K, H, tp, dev)
    if route != ("kernel", "full" if full else "partial"):
        raise ValueError(f"C {C}, {K} taps, H {H} over {tp} ranks routes to {route}, not the "
                         f"{'K5' if full else 'K6'} TP form")
    go = grad_out.to(torch.bfloat16).contiguous()
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    Hr, Hp = pack.H, pack.Hp
    nwg, sb = tp_bwd_plan(BL, C, H, tp, device_sms(dev), film=False)
    ws, ss = split_partials(buf, BL, C)
    frows = bwd_rows(C)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    y, rows = torch.empty(BL, C, **bf), torch.empty(BL, 2, **f32)
    dvg, hn = torch.empty(BL, 2 * Hp, **bf), torch.empty(BL, Hp, **bf)
    dbvg = torch.empty(-(-BL // (64 * nwg)) * nwg, 2 * Hp, **f32)
    dy, dysum = tp_dy(sb, BL, C, dev)
    fin = torch.empty(B, -(-L // frows), 2 + K, C, **f32)
    ptrs = [x.data_ptr(), go.data_ptr(), pack.dww.data_ptr(), pack.dwb.data_ptr(),
            pack.bvg.data_ptr(), pack.weight_maps(), dx.data_ptr(), ws.data_ptr(), ss.data_ptr(),
            *(t.data_ptr() for t in (y, rows, dvg, hn, dbvg, dy, dysum, fin))]
    dims = [B, L, C, Hr, Hp, H, K, nwg, ws.shape[0], sb, frows]
    if full:
        s_vg, s_out = gemm_splits(BL, C, 2 * Hp), gemm_splits(BL, Hp, C)
        prods = [torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32),
                 torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)]
        fn, kernel = "odt_swiglu_bwd_full_tp", "swiglu_bwd_full_tp"
        args = [*ptrs, *(t.data_ptr() for t in prods), *dims, s_vg, s_out]
    else:
        fn, kernel, args = "odt_swiglu_bwd_tp", "swiglu_bwd_tp", [*ptrs, *dims]
    run(fn, kernel, dev, *args, 0)
    if full:
        dwvg, dwout = prods[2:]
    else:
        dwvg = torch.mm(y.t(), dvg, out_dtype=torch.float32)
        dwout = torch.mm(hn.t(), go.reshape(BL, C), out_dtype=torch.float32)
    db = dbvg.sum(0)
    slice_grads = (torch.cat([dwvg[:, :Hr], dwvg[:, Hp : Hp + Hr]], 1),
                   torch.cat([db[:Hr], db[Hp : Hp + Hr]]), dwout[:Hr])

    def finish(held=(x, go, pack, buf, y, rows, dvg, hn, dbvg, dy, dysum)):
        """phase 1 (``held``: the tensors behind ``args``, alive until it
        has read them)"""
        run(fn, kernel, dev, *args, 1, count=False)
        sums = fin.sum((0, 1))  # d dw_bias, d out_bias, the taps
        return dx, sums[2:], sums[0], sums[1]

    return dysum, slice_grads, finish


class SwiGLUTPFunction(torch.autograd.Function):
    """the TP forms of one rank's slice, routed as ``swiglu_tp_route`` says
    (on the card the K4 TP form forward, then the K5 or K6 TP form or the
    plain version backward), their partial sums all-reduced over the model
    group ``group`` between the phases; H the whole hidden width"""

    @staticmethod
    def forward(ctx, x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, H, group):
        tp = group_size(group)
        buf = swiglu_tp_partial(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, H, tp)
        tp_all_reduce_(buf, group)
        ctx.save_for_backward(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, buf)
        ctx.H, ctx.group = H, group
        kernel = _tp_route(x, dw_kernel, H, tp)[0] == "kernel"
        return swiglu_tp_finish(buf, x, out_bias, H, kernel)

    @staticmethod
    def backward(ctx, grad_out):
        x, *weights, buf = ctx.saved_tensors
        dy, (dvgk, dvgb, doutk), finish = swiglu_tp_bwd(
            x, *weights, grad_out, buf, ctx.H, group_size(ctx.group))
        tp_all_reduce_(dy, ctx.group)
        dx, ddw, ddwb, dbout = finish()
        dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel = weights
        return (dx.to(x.dtype), ddw.to(dw_kernel.dtype), ddwb.to(dw_bias.dtype),
                dvgk.to(vg_kernel.dtype), dvgb.to(vg_bias.dtype), doutk.to(out_kernel.dtype),
                dbout.to(out_kernel.dtype), None, None)


def swiglu_tp(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, H: int, group
              ) -> torch.Tensor:
    """SwiGLU on a tensor-parallel rank holding a slice of the H hidden units
    (``vg_kernel`` (C, 2 H_r), ``out_kernel`` (H_r, C)): the TP forms routed
    as the one-rank op (``swiglu_tp_route``); the model group ``group`` sums
    the partials"""
    return SwiGLUTPFunction.apply(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
                                  H, group)
