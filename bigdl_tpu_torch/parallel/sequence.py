"""Sequence (context) parallelism: ring, zigzag ring and Ulysses attention.

Counterpart of `bigdl_tpu/parallel/sequence.py`. The JAX package runs one
program over a mesh axis with `shard_map`; the port keeps that
single-controller model. A per-shard function here takes lists of
`[B, H, T/n, D]` tensors, one for each position along the mesh axis and
each on that position's device, runs all n shards hop by hop in lockstep,
and returns a list.

- **Ring**: Q stays put and the K/V shards rotate (`lax.ppermute`
  becomes moving position i's K/V to position i + 1's device, a no-op when
  both are the same device; the last hop does not rotate). Every hop
  continues one online softmax (acc, m, l) through the carry kernel
  (`ops.attention_kernel.flash_attention_carry`, kernel 2), n^2 launches a
  call, the fully masked hops included, as in JAX.
- **Zigzag**: position d holds sequence chunks d and 2n-1-d, so the
  causal work is balanced over the positions; the chunk pairs that are
  wholly masked are skipped on the host (JAX's `lax.cond`) and launch
  nothing: n(2n+1) launches a call.
- **Ulysses**: heads are swapped for sequence (the all-to-all), each
  position runs `blockwise_attention` over the whole sequence for its
  heads, and the inverse swap restores sequence sharding. It runs no
  kernel, as in JAX.

Ring and zigzag are differentiable through a `torch.autograd.Function`
whose backward recomputes the plain blockwise ring under autograd, the
twin of the JAX package's custom-vjp backward through XLA (there is no
Pallas backward for the ring). `make_sequence_parallel_attention` wraps
them for global `[B, H, T, D]` tensors over a `Mesh`.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.ops import attention_kernel as ak
from bigdl_tpu_torch.parallel.mesh import Mesh

Shards = Sequence[torch.Tensor]


def _check_shards(qs: Shards, ks: Shards, vs: Shards) -> int:
    n = len(qs)
    if n == 0 or len(ks) != n or len(vs) != n:
        raise ValueError(f"{len(qs)} q, {len(ks)} k and {len(vs)} v shards")
    for q, k, v in zip(qs, ks, vs):
        if q.shape != qs[0].shape or k.shape != q.shape \
                or v.shape != q.shape:
            raise ValueError("every q, k and v shard must have one shape, "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)} and {tuple(qs[0].shape)}")
        if not (q.device == k.device == v.device):
            raise ValueError("a position's q, k and v shards must be on "
                             "one device")
    return n


def _rotate(held: list, qs: Shards) -> list:
    """One ring step: position i + 1 receives what position i holds, on
    its own device (`lax.ppermute` with perm i -> i + 1)."""
    n = len(held)
    return [tuple(t.to(qs[j].device) for t in held[(j - 1) % n])
            for j in range(n)]


def _hop(use_kernel: bool, block_k: int):
    """The per-hop update: kernel 2 through `flash_attention_carry` (its
    plain version on a CPU tensor), updating the carry in place, or the
    plain blockwise step that autograd can record."""
    if use_kernel:
        def update(q, k, v, state, causal, sm_scale, q_off, k_off):
            return ak.flash_attention_carry(q, k, v, state, causal, sm_scale,
                                            q_off, k_off, inplace=True)
    else:
        def update(q, k, v, state, causal, sm_scale, q_off, k_off):
            return ak.blockwise_attention(q, k, v, causal, sm_scale, block_k,
                                          q_off, k_off, carry=state,
                                          finish=False)
    return update


def _ring_program(qs, ks, vs, use_kernel, causal, sm_scale, block_k):
    n = len(qs)
    t_local = qs[0].shape[2]
    sm_scale = sm_scale or qs[0].shape[-1] ** -0.5
    update = _hop(use_kernel, block_k)
    states = [ak.attention_state_init(q) for q in qs]
    held = list(zip(ks, vs))
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n  # position the held K/V shard came from
            k, v = held[idx]
            states[idx] = update(qs[idx], k, v, states[idx], causal,
                                 sm_scale, idx * t_local, src * t_local)
        if i + 1 < n:  # the last hop needs no rotation
            held = _rotate(held, qs)
    return [ak.attention_state_finish(*s).to(q.dtype)
            for s, q in zip(states, qs)]


def _zigzag_program(qs, ks, vs, use_kernel, sm_scale, block_k):
    n = len(qs)
    if qs[0].shape[2] % 2:
        raise ValueError("zigzag needs an even local sequence length")
    c = qs[0].shape[2] // 2
    sm_scale = sm_scale or qs[0].shape[-1] ** -0.5
    update = _hop(use_kernel, block_k)

    def halves(x):
        return x[:, :, :c].contiguous(), x[:, :, c:].contiguous()

    q1s, q2s = zip(*(halves(q) for q in qs))
    s1 = [ak.attention_state_init(q) for q in q1s]
    s2 = [ak.attention_state_init(q) for q in q2s]
    # (kA, vA, kB, vB): the held shard's low chunk A and high chunk B
    held = []
    for k, v in zip(ks, vs):
        (k_a, k_b), (v_a, v_b) = halves(k), halves(v)
        held.append((k_a, v_a, k_b, v_b))
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n
            k_a, v_a, k_b, v_b = held[idx]
            off_q1, off_q2 = idx * c, (2 * n - 1 - idx) * c
            a_off, b_off = src * c, (2 * n - 1 - src) * c
            # q_high vs A: strictly below the diagonal for every (d, src)
            s2[idx] = update(q2s[idx], k_a, v_a, s2[idx], False, sm_scale,
                             off_q2, a_off)
            # q_low vs A: on or below the diagonal only when src <= d
            if src <= idx:
                s1[idx] = update(q1s[idx], k_a, v_a, s1[idx], True,
                                 sm_scale, off_q1, a_off)
            # q_high vs B: on or below the diagonal only when src >= d
            if src >= idx:
                s2[idx] = update(q2s[idx], k_b, v_b, s2[idx], True,
                                 sm_scale, off_q2, b_off)
            # q_low vs B is always wholly masked: never computed
        if i + 1 < n:
            held = _rotate(held, qs)
    return [torch.cat([ak.attention_state_finish(*a),
                       ak.attention_state_finish(*b)], dim=2).to(q.dtype)
            for a, b, q in zip(s1, s2, qs)]


class _KernelRing(torch.autograd.Function):
    """A ring program with kernel 2 in the forward (under no grad) and,
    in the backward, autograd through the same program with the plain
    blockwise hop, recomputed from the saved shards."""

    @staticmethod
    def forward(ctx, program, n, *shards):
        ctx.program, ctx.n = program, n
        ctx.save_for_backward(*shards)
        with torch.no_grad():
            outs = program(shards[:n], shards[n:2 * n], shards[2 * n:],
                           True)
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        n = ctx.n
        shards = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.program(shards[:n], shards[n:2 * n], shards[2 * n:],
                               False)
            got = torch.autograd.grad(outs, shards, grads)
        return (None, None, *got)


def _run(program: Callable, qs: Shards, ks: Shards, vs: Shards
         ) -> List[torch.Tensor]:
    n = _check_shards(qs, ks, vs)
    flat = (*qs, *ks, *vs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return list(_KernelRing.apply(program, n, *flat))
    return program(qs, ks, vs, True)


def ring_attention(q: Shards, k: Shards, v: Shards, causal: bool = False,
                   sm_scale: Optional[float] = None, block_k: int = 512
                   ) -> List[torch.Tensor]:
    """Exact attention over sequence shards: q, k, v are lists of
    `[B, H, T/n, D]` tensors, position i holding tokens
    `[i * T/n, (i + 1) * T/n)` on its device. Returns the output shards.
    Causal masking uses global offsets, so the result is the unsharded
    attention's. `block_k` is the plain (backward) path's block; kernel 2
    tiles itself."""
    program = functools.partial(_ring_program, causal=causal,
                                sm_scale=sm_scale, block_k=block_k)
    return _run(program, q, k, v)


def _require_causal(causal: bool) -> None:
    if not causal:
        raise ValueError("zigzag ring is a causal-balance scheme; use "
                         "scheme='ring' for non-causal")


def zigzag_ring_attention(q: Shards, k: Shards, v: Shards,
                          causal: bool = True,
                          sm_scale: Optional[float] = None,
                          block_k: int = 512) -> List[torch.Tensor]:
    """Load-balanced causal ring attention over zigzag shards: position d
    holds chunks d and 2n-1-d of the sequence (c = T/2n tokens each),
    concatenated (`zigzag_order` makes the layout). Returns the output
    shards in the same layout. Of each hop's four chunk pairs, q_low vs
    B is always masked and is never computed, q_high vs A is never
    masked, and the two diagonal pairs run only where they see a key.
    Requires `causal=True` and an even local length."""
    _require_causal(causal)
    program = functools.partial(_zigzag_program, sm_scale=sm_scale,
                                block_k=block_k)
    return _run(program, q, k, v)


def zigzag_order(n: int, t: int) -> np.ndarray:
    """Global T-length permutation, natural order -> zigzag layout
    (position d's shard = chunks d and 2n-1-d)."""
    c = t // (2 * n)
    if t % (2 * n):
        raise ValueError(f"T={t} must divide by 2*axis_size={2 * n}")
    order = []
    for d in range(n):
        order.extend(range(d * c, (d + 1) * c))
        order.extend(range((2 * n - 1 - d) * c, (2 * n - d) * c))
    return np.asarray(order)


def zigzag_inverse(n: int, t: int) -> np.ndarray:
    order = zigzag_order(n, t)
    inv = np.empty_like(order)
    inv[order] = np.arange(t)
    return inv


def ulysses_attention(q: Shards, k: Shards, v: Shards, causal: bool = False,
                      sm_scale: Optional[float] = None
                      ) -> List[torch.Tensor]:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style): the
    `[B, H, T/n, D]` shards are regrouped to `[B, H/n, T, D]` (position j
    takes heads j*H/n .. (j+1)*H/n of every shard), each position runs
    `blockwise_attention` over the whole sequence, and the inverse regroup
    restores sequence sharding. Requires H % n == 0; differentiable by
    autograd."""
    n = _check_shards(q, k, v)
    b, h, t_loc, d = q[0].shape
    if h % n:
        raise ValueError(f"n_head {h} must divide by axis size {n}")
    hn = h // n
    devs = [x.device for x in q]

    def scatter_heads(xs):
        return [torch.cat([x[:, j * hn:(j + 1) * hn].to(devs[j])
                           for x in xs], dim=2) for j in range(n)]

    def gather_heads(xs):
        return [torch.cat([x[:, :, i * t_loc:(i + 1) * t_loc].to(devs[i])
                           for x in xs], dim=1) for i in range(n)]

    o = [ak.blockwise_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
         for qh, kh, vh in zip(scatter_heads(q), scatter_heads(k),
                               scatter_heads(v))]
    return [x.to(q[0].dtype) for x in gather_heads(o)]


_SCHEMES = ("ring", "ulysses", "zigzag")


def _axis_devices(mesh: Mesh, axis_name: str) -> list:
    """The devices along `axis_name`, at index 0 of every other axis."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"no axis {axis_name!r} in mesh axes "
                         f"{mesh.axis_names}")
    axis = mesh.axis_names.index(axis_name)
    devs = np.moveaxis(mesh.devices, axis, 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def make_sequence_parallel_attention(mesh: Mesh, scheme: str = "ring",
                                     axis_name: str = "data",
                                     causal: bool = False):
    """`fn(q, k, v) -> out` on global `[B, H, T, D]` tensors: T is split
    over the devices along `axis_name`, the scheme runs over the shards,
    and the output is concatenated back on q's device. Over a mesh with
    other axes it computes along `axis_name` at index 0 of the others (the
    replicas would compute the same values). Zigzag reorders the sequence
    with `zigzag_order` before and `zigzag_inverse` after, so callers keep
    natural order.

        >>> import torch
        >>> from bigdl_tpu_torch.parallel import build_mesh
        >>> from bigdl_tpu_torch.ops.attention_kernel import naive_attention
        >>> mesh = build_mesh(data=4, devices=["cpu"] * 4)
        >>> attn = make_sequence_parallel_attention(mesh, "ring")
        >>> q, k, v = torch.randn(3, 1, 2, 16, 8).unbind(0)
        >>> torch.allclose(attn(q, k, v), naive_attention(q, k, v),
        ...                atol=1e-5)
        True
    """
    if scheme not in _SCHEMES:
        raise ValueError(f"scheme must be ring|ulysses|zigzag, got {scheme}")
    devices = _axis_devices(mesh, axis_name)
    n = len(devices)
    per_shard = {"ring": functools.partial(ring_attention, causal=causal),
                 "zigzag": functools.partial(zigzag_ring_attention,
                                             causal=causal),
                 "ulysses": functools.partial(ulysses_attention,
                                              causal=causal)}[scheme]

    def fn(q, k, v):
        if scheme == "zigzag":
            _require_causal(causal)
        if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"q, k, v must be one [B, H, T, D] shape, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        t = q.shape[2]
        if scheme == "zigzag":
            order = torch.from_numpy(zigzag_order(n, t)).to(q.device)
            q, k, v = (x.index_select(2, order) for x in (q, k, v))
        elif t % n:
            raise ValueError(f"T={t} must divide by axis size {n}")
        tl = t // n
        shards = [[x[:, :, i * tl:(i + 1) * tl].to(devices[i]).contiguous()
                   for i in range(n)] for x in (q, k, v)]
        out = torch.cat([o.to(q.device) for o in per_shard(*shards)], dim=2)
        if scheme == "zigzag":
            inv = torch.from_numpy(zigzag_inverse(n, t)).to(q.device)
            out = out.index_select(2, inv)
        return out

    return fn


class SequenceParallelAttention:
    """Holds the mesh and scheme and exposes `__call__(q, k, v)` on
    global tensors (thin, as in the JAX package)."""

    def __init__(self, mesh: Mesh, scheme: str = "ring",
                 axis_name: str = "data", causal: bool = False):
        self.fn = make_sequence_parallel_attention(mesh, scheme, axis_name,
                                                   causal)
        self.mesh, self.axis_name = mesh, axis_name

    def __call__(self, q, k, v):
        return self.fn(q, k, v)
