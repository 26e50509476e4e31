"""Ring attention — sequence-parallel attention over the ``sp`` axis of a
mesh (counterpart of the JAX package's parallel/ring_attention.py).

The sequence is cut into n blocks, one per device along the mesh axis.
Each device keeps its query block and its online-softmax carry; K/V
blocks rotate around the ring, so after n − 1 rotations every query
block has attended every key block and the (S × S) scores never exist
in full. Causal masking places each block by its global offsets.

The JAX package runs this under `shard_map` with `lax.ppermute`. The port
drives the same program from one process: a rotation is a copy of each
K/V block to the next shard's device (``t.to(dev, non_blocking=True)``,
peer to peer between cards, no copy at all when two shards share a
card), and the shards' outputs are gathered onto q's device. Rotating
blocks are only read, never written, so no shard writes into a block
another shard still reads. Each step's math is either the hand-written
`flash_block_update` kernel (backends/kernels.py) or the einsum of
`_block_attn`.

`reference_attention` is the single-device ground truth, and the
``attn="xla"`` arm of `transformer.apply_seq`.
"""

from __future__ import annotations

import torch

from nnstreamer_tpu_torch.core.errors import BackendError

NEG_INF = -1e30


def _block_attn(q, k, v, m_prev, l_prev, o_prev, mask=None):
    """One online-softmax accumulation step.

    q: (B, Sq, H, D), k/v: (B, Sk, H, D); m/l: (B, H, Sq) running max /
    normaliser; o: (B, Sq, H, D) f32 unnormalised output accumulator.
    → (m, l, o)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # fully masked rows have s == m_new == NEG_INF → exp(0) = 1; zero them
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_new = o_prev * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def _ring(q, k, v, devs, causal: bool, use_kernel: bool):
    """One ring over `devs` for (B, S, H, D) q/k/v → the output in q's
    dtype on q's device."""
    from nnstreamer_tpu_torch.backends import kernels

    n = len(devs)
    b, s, h, d = q.shape
    sl = s // n
    qs = [q[:, i * sl:(i + 1) * sl].to(devs[i], non_blocking=True)
          for i in range(n)]
    kb = [k[:, i * sl:(i + 1) * sl].to(devs[i], non_blocking=True)
          for i in range(n)]
    vb = [v[:, i * sl:(i + 1) * sl].to(devs[i], non_blocking=True)
          for i in range(n)]
    if use_kernel:
        # the kernel reads (B, H, S, D) views of the (B, S, H, D) shards
        qs = [t.transpose(1, 2) for t in qs]
        kb = [t.transpose(1, 2) for t in kb]
        vb = [t.transpose(1, 2) for t in vb]
        carry = [kernels.flash_carry_init(b * h, sl, d, device=devs[i])
                 for i in range(n)]
    else:
        carry = [(torch.full((b, h, sl), NEG_INF, device=devs[i]),
                  torch.zeros((b, h, sl), device=devs[i]),
                  torch.zeros((b, sl, h, d), device=devs[i]))
                 for i in range(n)]
    for step in range(n):
        for i in range(n):
            # blocks rotate i → i+1 each step, so after `step` steps shard
            # i holds the block that started on shard (i - step) mod n
            src = (i - step) % n
            if use_kernel:
                kernels.flash_block_update(
                    qs[i], kb[i], vb[i], *carry[i], q_offset=i * sl,
                    k_offset=src * sl, causal=causal)
                continue
            mask = None
            if causal:
                iq = i * sl + torch.arange(sl, device=devs[i])
                mask = (iq[:, None] >= src * sl + torch.arange(
                    sl, device=devs[i])[None, :])[None, None]
            carry[i] = _block_attn(qs[i], kb[i], vb[i], *carry[i], mask)
        if step < n - 1:          # the n-th rotation would be wasted
            kb = [kb[(i - 1) % n].to(devs[i], non_blocking=True)
                  for i in range(n)]
            vb = [vb[(i - 1) % n].to(devs[i], non_blocking=True)
                  for i in range(n)]
    outs = []
    for i, (_, l, acc) in enumerate(carry):
        if use_kernel:
            o = kernels.flash_carry_finalize(l, acc).reshape(
                b, h, sl, d).transpose(1, 2)
        else:
            o = acc / l.clamp_min(1e-20).transpose(1, 2)[..., None]
        outs.append(o.to(q.dtype).to(q.device, non_blocking=True))
    return torch.cat(outs, dim=1)


def ring_attention(q, k, v, *, mesh, axis: str = "sp", causal: bool = False,
                   block_impl: str = "auto", batch_axis: str = None):
    """Sequence-parallel attention. q/k/v: (B, S, H, D) on one device;
    S is split over the `mesh` devices along `axis`, and, with
    `batch_axis`, B over the groups along that axis (each group runs its
    own ring: the dp × sp layout). Returns (B, S, H, D) in q's dtype on
    q's device.

    `block_impl` picks each step's math: "pallas" = the
    `flash_block_update` kernel (its plain version for CPU tensors),
    "xla" = the einsum of `_block_attn`, "auto" = the kernel for CUDA
    tensors when the local block is a multiple of 128, else the
    einsum."""
    from nnstreamer_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise BackendError(
            f"ring_attention needs a parallel.mesh.Mesh (make_mesh), got "
            f"{type(mesh).__name__}")
    if block_impl not in ("auto", "pallas", "xla"):
        raise BackendError(
            f"block_impl must be 'auto', 'pallas' or 'xla', got "
            f"{block_impl!r}")
    n = mesh.shape.get(axis, 0)
    groups = mesh.shape[batch_axis] if batch_axis else 1
    b, s = q.shape[:2]
    if not n or s % n or b % groups:
        raise BackendError(
            f"ring_attention over {mesh.shape}: sequence {s} must divide by "
            f"the {axis!r} axis and batch {b} by the "
            f"{batch_axis!r} axis")
    s_local = s // n
    use_kernel = block_impl == "pallas" or (
        block_impl == "auto" and q.is_cuda and s_local % 128 == 0)
    bl = b // groups
    outs = []
    for g in range(groups):
        devs = mesh.along(axis, {batch_axis: g} if batch_axis else None)
        rows = slice(g * bl, (g + 1) * bl)
        outs.append(_ring(q[rows], k[rows], v[rows], devs, causal,
                          use_kernel))
    return outs[0] if groups == 1 else torch.cat(outs, dim=0)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False) -> torch.Tensor:
    """(B, S, H, D) attention with the whole row's softmax: scores in f32
    (inputs widened, as JAX's f32-preferred einsum), −1e30 above the
    diagonal when causal, p cast to v's dtype before the product with v,
    the result in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
