"""Attention layers and transformer blocks (counterpart of
`bigdl_tpu/nn/attention.py`).

Head-major [B, H, T, D] attention. Projections keep the JAX package's
`[in, out]` weight layout as raw parameters and compute `x @ W`, so the
JAX parameter tree carries over without transposes
(`interop/jax_params.py`).

The decode KV cache is updated in place (`cache_write`, `cache_commit`):
what buffer donation gives the JAX package, PyTorch gives by writing into
the preallocated tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import Xavier, default_generator
from bigdl_tpu_torch.nn.normalization import LayerNormalization
from bigdl_tpu_torch.ops.attention_kernel import (flash_attention,
                                                  naive_attention)


def rope(x, positions=None, base: float = 10000.0):
    """Rotary position embedding over [B, H, T, D] (D even), interleaved:
    the pairs are x[..., 0::2] and x[..., 1::2]. Angles are f32; the result
    keeps x's dtype. `positions` is [T] (shared; default `arange(T)`) or
    [B, T] (per row: the decode path, each slot at its own position)."""
    b, h, t, d = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    inv = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                 device=x.device) / d)            # [D/2]
    ang = positions.float()[..., :, None] * inv                  # [(B,)T,D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    if positions.dim() == 2:  # per-row positions: broadcast over heads
        sin, cos = sin[:, None], cos[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, h, t, d).to(x.dtype)


def cache_write(cache, new, positions):
    """Write `new` [B, H, T, hd] into `cache` [B, H, L, hd] in place, row b
    starting at sequence position `positions[b]` (clamped so the write
    fits, as `lax.dynamic_update_slice` does). Returns `cache`."""
    b, _, length, _ = cache.shape
    t = new.shape[2]
    start = torch.as_tensor(positions, device=cache.device).long()
    start = start.clamp(0, length - t)
    idx = start[:, None] + torch.arange(t, device=cache.device)   # [B, T]
    rows = torch.arange(b, device=cache.device)[:, None]
    cache[rows, :, idx] = new.transpose(1, 2).to(cache.dtype)    # [B,T,H,hd]
    return cache


def cache_commit(cache, new, slot_ids):
    """Commit per-request prefill K/V `new` [B, H, T, hd] into slots of a
    cache [S, H, L, hd] at sequence position 0, in place. Rows may repeat:
    bucket padding replicates the last request's row INCLUDING its slot
    id. Rows are written one by one in request order, so the last write
    wins (the duplicates are identical anyway). Returns `cache`."""
    t = new.shape[2]
    for j, s in enumerate(torch.as_tensor(slot_ids).tolist()):
        if not 0 <= s < cache.shape[0]:
            raise IndexError(f"slot id {s} outside [0, {cache.shape[0]})")
        cache[s, :, :t] = new[j]
    return cache


def dropout(x, p: float, generator: torch.Generator):
    """Inverted dropout: each element kept with probability 1 - p (bits
    from `generator`, on x's device) and scaled by 1 / (1 - p), the
    reference's `x * bernoulli(keep) / keep`."""
    keep = 1.0 - p
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * kept.to(x.dtype) / keep


class ScaledDotProductAttention(nn.Module):
    """attention(q, k, v) with an optional causal mask; q, k, v
    [B, H, T, D]."""

    def __init__(self, causal: bool = False, use_flash: bool = True,
                 sm_scale: Optional[float] = None):
        super().__init__()
        self.causal, self.use_flash, self.sm_scale = causal, use_flash, \
            sm_scale

    def forward(self, q, k, v):
        if self.use_flash:
            return flash_attention(q, k, v, self.causal, self.sm_scale)
        return naive_attention(q, k, v, self.causal, self.sm_scale)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v projections.

    Input: [B, T, E] (self-attention) or a pair (query [B, Tq, E],
    key_value [B, Tk, E]) for cross attention. Bias and RoPE optional.
    Weights are drawn from `generator` (default: seed 0) on `device`
    (default: CUDA; see `resolve_device`)."""

    def __init__(self, embed_dim: int, n_head: int, causal: bool = False,
                 with_bias: bool = True, use_rope: bool = False,
                 use_flash: bool = True, kv_embed_dim: Optional[int] = None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} % n_head {n_head} != 0")
        device = resolve_device(device)
        g = default_generator(generator)
        self.e, self.h = embed_dim, n_head
        self.hd = embed_dim // n_head
        self.causal, self.with_bias = causal, with_bias
        self.use_rope, self.use_flash = use_rope, use_flash
        self.kv_e = kv_embed_dim or embed_dim
        xav = Xavier()
        for name, fan_in in (("wq", self.e), ("wk", self.kv_e),
                             ("wv", self.kv_e), ("wo", self.e)):
            setattr(self, name, nn.Parameter(
                xav(g, (fan_in, self.e), device=device)))
        if with_bias:
            for name in ("bq", "bk", "bv", "bo"):
                setattr(self, name, nn.Parameter(
                    torch.zeros(self.e, device=device)))

    def _split(self, x):  # [B,T,E] -> [B,H,T,hd]
        b, t, _ = x.shape
        return x.reshape(b, t, self.h, self.hd).transpose(1, 2)

    def _merge(self, x):  # [B,H,T,hd] -> [B,T,E]
        b, h, t, hd = x.shape
        return x.transpose(1, 2).reshape(b, t, h * hd)

    def project_qkv(self, xq, xkv=None, positions=None):
        """Linear projections + bias + head split + (optional) RoPE at
        `positions` ([T], [B, T], or None = `arange`). Returns post-RoPE
        q, k, v [B, H, T, hd]."""
        if xkv is None:
            xkv = xq
        q, k, v = xq @ self.wq, xkv @ self.wk, xkv @ self.wv
        if self.with_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k, v = self._split(q), self._split(k), self._split(v)
        if self.use_rope:
            q, k = rope(q, positions), rope(k, positions)
        return q, k, v

    def _attend(self, q, k, v):
        if self.use_flash:
            return flash_attention(q, k, v, self.causal)
        return naive_attention(q, k, v, self.causal)

    def _finish(self, o):
        o = self._merge(o) @ self.wo
        if self.with_bias:
            o = o + self.bo
        return o

    def forward(self, x):
        xq, xkv = x if isinstance(x, (tuple, list)) else (x, x)
        return self._finish(self._attend(*self.project_qkv(xq, xkv)))

    def apply_step(self, x, k_cache, v_cache, positions):
        """One-token attention against a KV cache: `x` [B, 1, E] holds one
        new token per row, `k_cache`/`v_cache` [B, H, L, hd] each row's
        history, `positions` [B] each row's 0-based position. Writes the
        new post-RoPE K/V at `positions` (in place), then attends over keys
        at positions <= the row's own, so rows of mixed ages share one
        fixed-shape step. Returns (out [B, 1, E], k_cache, v_cache)."""
        q, k, v = self.project_qkv(x, positions=positions[:, None])
        k_cache = cache_write(k_cache, k, positions)
        v_cache = cache_write(v_cache, v, positions)
        length = k_cache.shape[2]
        mask = (torch.arange(length, device=x.device)[None, :]
                <= positions[:, None])[:, None, None, :]
        o = naive_attention(q, k_cache, v_cache, mask=mask)
        return self._finish(o), k_cache, v_cache


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)); x + MLP(LN(x)), with
    the tanh-approximated GELU (`jax.nn.gelu`'s default).

    `dropout` (training mode only) drops the MLP's hidden activation and
    scales what it keeps by `1 / keep`, as the reference does. Its bits
    come from `dropout_generator`, a `torch.Generator` on the block's
    device (default: a fresh one seeded 0); they are not `jax.random`'s
    bits, so dropout matches the reference in distribution only."""

    def __init__(self, embed_dim: int, n_head: int, mlp_ratio: int = 4,
                 causal: bool = False, use_rope: bool = False,
                 use_flash: bool = True, dropout: float = 0.0, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        device = resolve_device(device)
        g = default_generator(generator)
        self.attn = MultiHeadAttention(embed_dim, n_head, causal=causal,
                                       use_rope=use_rope, use_flash=use_flash,
                                       device=device, generator=g)
        self.ln1 = LayerNormalization(embed_dim, device=device)
        self.ln2 = LayerNormalization(embed_dim, device=device)
        self.e, self.hidden = embed_dim, embed_dim * mlp_ratio
        xav = Xavier()
        self.w1 = nn.Parameter(xav(g, (self.e, self.hidden), device=device))
        self.b1 = nn.Parameter(torch.zeros(self.hidden, device=device))
        self.w2 = nn.Parameter(xav(g, (self.hidden, self.e), device=device))
        self.b2 = nn.Parameter(torch.zeros(self.e, device=device))
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        if dropout and dropout_generator is None:
            self.dropout_generator = torch.Generator(device).manual_seed(0)

    def _mlp(self, x):
        """The inference-form MLP tail (no dropout), shared by the
        incremental step and the prefill."""
        h = self.ln2(x)
        h = F.gelu(h @ self.w1 + self.b1, approximate="tanh")
        return h @ self.w2 + self.b2

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        if not (self.dropout and self.training):
            return x + self._mlp(x)
        h = F.gelu(self.ln2(x) @ self.w1 + self.b1, approximate="tanh")
        h = dropout(h, self.dropout, self.dropout_generator)
        return x + (h @ self.w2 + self.b2)

    def apply_step(self, x, k_cache, v_cache, positions):
        """One-token block apply: x [B, 1, E] at per-row `positions` [B]
        against this layer's KV cache. Returns (out, k_cache, v_cache)."""
        a, k_cache, v_cache = self.attn.apply_step(
            self.ln1(x), k_cache, v_cache, positions)
        x = x + a
        return x + self._mlp(x), k_cache, v_cache

    def apply_prefill(self, x):
        """Full-sequence apply that also returns this layer's post-RoPE
        K/V [B, H, T, hd] for the decode cache. Same math as `forward`."""
        q, k, v = self.attn.project_qkv(self.ln1(x))
        x = x + self.attn._finish(self.attn._attend(q, k, v))
        return x + self._mlp(x), k, v
