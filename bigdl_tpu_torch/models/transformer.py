"""Decoder-only transformer language model (counterpart of
`bigdl_tpu/models/transformer.py`).

Causal LM over 1-based token ids: [B, T] tokens -> [B, T, vocab]
log-probs. Pre-norm blocks with interleaved RoPE. `forward` in training
mode is the training path: attention through `flash_attention`, whose
backward runs the flash backward kernels. Prefill attention goes through
the flash forward kernel (`ops/attention_kernel.py`), the one-token decode
step through `naive_attention` over the KV cache.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.attention import TransformerBlock, cache_commit
from bigdl_tpu_torch.nn.initialization import Xavier, default_generator


class TransformerLM(nn.Module):
    """[B, T] int tokens (1-based) -> [B, T, vocab] log-probs.

    Runs on `device` (default CUDA; pass `device="cpu"` for the CPU).
    Weights are drawn from `generator` (default: seed 0) and are random;
    `interop.jax_params.load_transformer_lm_params` carries trained JAX
    weights over. `dropout` applies in training mode, with bits from
    `dropout_generator` (a `torch.Generator` on `device`, default the
    first block's fresh one seeded 0) shared by every block."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 n_layer: int = 4, n_head: int = 4, mlp_ratio: int = 4,
                 max_len: Optional[int] = None, use_flash: bool = True,
                 dropout: float = 0.0, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.vocab, self.e = vocab_size, embed_dim
        self.max_len = max_len  # a guard: RoPE has no table size
        self.n_layer = n_layer
        self.embed = nn.Parameter(
            (torch.randn((vocab_size, embed_dim), generator=g) * 0.02)
            .to(device))
        self.head = nn.Parameter(
            Xavier()(g, (embed_dim, vocab_size), device=device))
        blocks = []
        for _ in range(n_layer):  # every block takes the first's generator
            blocks.append(TransformerBlock(
                embed_dim, n_head, mlp_ratio=mlp_ratio, causal=True,
                use_rope=True, use_flash=use_flash, dropout=dropout,
                device=device, generator=g,
                dropout_generator=dropout_generator))
            dropout_generator = blocks[-1].dropout_generator
        self.blocks = nn.ModuleList(blocks)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens):
        tokens = torch.as_tensor(tokens, device=self.device)
        return self.embed[tokens.long() - 1]  # 1-based ids

    def forward(self, tokens):
        if self.max_len is not None and tokens.shape[1] > self.max_len:
            raise ValueError(f"sequence length {tokens.shape[1]} exceeds "
                             f"max_len {self.max_len}")
        x = self._embed(tokens)
        for blk in self.blocks:
            x = blk(x)
        return torch.log_softmax(x @ self.head, dim=-1)

    # ------------------------------------------------- incremental decoding
    def init_cache(self, slots: int, max_len: int, dtype=torch.float32):
        """Preallocated per-slot KV decode cache: {"k": [...], "v": [...]},
        n_layer fixed [slots, n_head, max_len, head_dim] tensors each,
        written in place by `apply_prefill` and `apply_step`."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        attn = self.blocks[0].attn
        shape = (slots, attn.h, max_len, attn.hd)
        return {k: [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in self.blocks] for k in ("k", "v")}

    def apply_step(self, tokens, cache, positions):
        """One decode step over ALL cache slots: `tokens` [S] (1-based, one
        per slot) at `positions` [S] (each slot's 0-based position; slots
        of mixed ages share the step). Writes each token's K/V at its
        position and returns ([S, vocab] next-token log-probs, cache)."""
        positions = torch.as_tensor(positions, device=self.device)
        x = self._embed(tokens)[:, None, :]
        for i, blk in enumerate(self.blocks):
            x, _, _ = blk.apply_step(x, cache["k"][i], cache["v"][i],
                                     positions)
        return torch.log_softmax(x[:, 0] @ self.head, dim=-1), cache

    def apply_prefill(self, tokens, cache, slot_ids, lengths):
        """Prefill a batch of prompts into cache slots: `tokens` [B, T]
        right-padded 1-based prompts, `slot_ids` [B] each prompt's slot,
        `lengths` [B] real lengths. One causal full-sequence forward (the
        right padding sits at later positions, which causal attention
        hides from real tokens) whose per-layer K/V land in the cache.
        Returns ([B, vocab] log-probs at each prompt's last real token,
        cache)."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            x, k, v = blk.apply_prefill(x)
            cache_commit(cache["k"][i], k, slot_ids)
            cache_commit(cache["v"][i], v, slot_ids)
        last = torch.as_tensor(lengths, device=self.device).long() - 1
        x_last = x[torch.arange(x.shape[0], device=self.device), last]
        return torch.log_softmax(x_last @ self.head, dim=-1), cache
