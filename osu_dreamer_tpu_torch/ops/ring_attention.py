"""Ring attention and the halo exchange: sequence parallelism over a group of
ranks.

Counterpart of osu_dreamer_tpu/ops/ring_attention.py. The length axis is
sharded over the ranks of a ``torch.distributed`` group (the JAX ``sp`` mesh
axis); each rank holds ``(B, L_shard, ...)``.

- ``ring_attention``: non-causal softmax attention over the whole sequence.
  Each rank keeps its queries and passes its key/value block round the ring
  (``ppermute`` in JAX, point-to-point sends here), merging every block into
  a streaming softmax (running max, sum and output, f32). Each rank keeps
  the blocks it saw for the backward, where it forms its queries' share of
  every block's dK/dV and a ring reduce-scatter sums each block's shares
  on their way to its owner: one f32 partial a step, no block sent again.
  The block products are torch products in f32, as the JAX ones are XLA
  einsums outside any Pallas kernel.
- ``halo_exchange``: ``radius`` real frames from each neighbour on either
  side of a shard, zeros at the global edges (the unsharded SAME padding), so
  a sharded convolution sees across shard boundaries. Its backward sends each
  halo's gradient back to the neighbour it came from, which adds it to its
  edge rows.

With a group of one rank (or ``group`` None) both reduce to the unsharded
computation.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import exchange, group_rank, group_size, ring_shift


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, Lq, D) f32 queries, (B, Lk, H, D) keys -> (B, H, Lq, Lk) f32"""
    return torch.einsum("bhqd,bkhd->bhqk", q, k.float()) * scale


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        n, i = group_size(group), group_rank(group)
        D = q.shape[-1]
        scale = D ** -0.5
        qf = q.float().transpose(1, 2)  # (B, H, Lq, D)
        B, H, Lq, _ = qf.shape
        o = qf.new_zeros(B, H, Lq, D)
        m = qf.new_full((B, H, Lq), float("-inf"))
        l = qf.new_zeros(B, H, Lq)
        blocks = [None] * n  # every rank's K|V block, kept for the backward
        kv = torch.cat([k, v], dim=-1)
        for step in range(n):
            if step:
                kv = ring_shift(kv, group)
            blocks[(i - step) % n] = kv
            kb, vb = kv.split(D, dim=-1)
            s = _block_scores(qf, kb, scale)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
            m = m_new
        out = o / l[..., None]
        ctx.group, ctx.scale = group, scale
        ctx.save_for_backward(q, out, m + torch.log(l), *blocks)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, out, lse, *blocks = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, i = group_size(group), group_rank(group)
        D = q.shape[-1]
        qf = q.float().transpose(1, 2)
        do = grad.float().transpose(1, 2)  # (B, H, Lq, D)
        delta = (do * out).sum(-1)  # (B, H, Lq)
        dq = torch.zeros_like(qf)
        partial = []  # this rank's queries' share of each block's dK | dV
        for kv in blocks:
            kb, vb = kv.split(D, dim=-1)
            p = torch.exp(_block_scores(qf, kb, scale) - lse[..., None])
            dv = torch.einsum("bhqk,bhqd->bkhd", p, do)
            ds = p * (torch.einsum("bhqd,bkhd->bhqk", do, vb.float()) - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds, kb.float()) * scale
            dk = torch.einsum("bhqk,bhqd->bkhd", ds, qf) * scale
            partial.append(torch.cat([dk, dv], dim=-1))
        # a ring reduce-scatter: block j's sum travels j+1 -> ... -> j,
        # each rank adding its share, and ends at its owner
        acc = partial[(i - 1) % n]
        for step in range(n - 1):
            acc = ring_shift(acc, group) + partial[(i - step - 2) % n]
        dk, dv = acc.to(blocks[i].dtype).split(D, dim=-1)
        return dq.transpose(1, 2).to(q.dtype), dk, dv, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """sequence-parallel non-causal attention: q, k, v (B, L_shard, H, D),
    each rank of ``group`` holding its span of the length axis in group-rank
    order -> (B, L_shard, H, D) in q's dtype (softmax statistics and
    products in f32)"""
    return _RingAttention.apply(q, k, v, group)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, radius, group):
        n, i = group_size(group), group_rank(group)
        r = radius
        B, L = x.shape[:2]
        halo = (B, r, *x.shape[2:])
        sends, recvs = [], []
        if i < n - 1:  # my tail -> the next shard's head halo
            sends.append((x[:, L - r:], i + 1))
        if i > 0:  # my head -> the previous shard's tail halo
            sends.append((x[:, :r], i - 1))
        if i > 0:
            recvs.append((halo, i - 1))
        if i < n - 1:
            recvs.append((halo, i + 1))
        got = exchange(sends, recvs, group, x.dtype, x.device, "halo") if n > 1 else []
        zeros = x.new_zeros(halo)
        from_prev = got.pop(0) if i > 0 else zeros
        from_next = got.pop(0) if i < n - 1 else zeros
        ctx.group, ctx.r, ctx.L = group, r, L
        return torch.cat([from_prev, x, from_next], dim=1)

    @staticmethod
    def backward(ctx, grad):
        group, r, L = ctx.group, ctx.r, ctx.L
        n, i = group_size(group), group_rank(group)
        gx = grad[:, r:r + L].clone()
        halo = (grad.shape[0], r, *grad.shape[2:])
        sends, recvs = [], []
        if i > 0:  # the gradient of the previous shard's tail
            sends.append((grad[:, :r], i - 1))
        if i < n - 1:  # the gradient of the next shard's head
            sends.append((grad[:, r + L:], i + 1))
        if i < n - 1:
            recvs.append((halo, i + 1))
        if i > 0:
            recvs.append((halo, i - 1))
        got = exchange(sends, recvs, group, grad.dtype, grad.device, "halo") if n > 1 else []
        if i < n - 1:
            gx[:, L - r:] += got.pop(0)
        if i > 0:
            gx[:, :r] += got.pop(0)
        return gx, None, None


def halo_exchange(x: torch.Tensor, radius: int, group) -> torch.Tensor:
    """(B, L_shard, C) -> (B, L_shard + 2 radius, C): ``radius`` real frames
    from the ring neighbours prepended and appended, zeros at the global
    first and last shards"""
    if x.shape[1] < radius:
        raise AssertionError(
            f"halo radius {radius} exceeds the {x.shape[1]}-frame local shard — "
            "lower parallel.sp (or raise seq_len) so each shard spans at least "
            "the conv receptive radius"
        )
    return _HaloExchange.apply(x, radius, group)
