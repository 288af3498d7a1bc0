"""Port parity: `bigdl_tpu_torch` TransformerLM and its layers against
`bigdl_tpu`.

The JAX `TransformerLM(vocab 64, embed 32, 2 layers, 4 heads)` is built
from a PRNG key and its parameters are carried into the port through
`load_transformer_lm_params`; both get the same numpy tokens. The JAX
model's prefill attention runs its Pallas forward kernel in interpret mode
(`INTERPRET`); the port's runs the kernel's plain version (CPU tensors).
Tolerance: atol 2e-5 on log-probs and cache contents (f32; the same math
through two frameworks and two layers), 1e-5 on single layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn.normalization import LayerNormalization as JaxLN
from bigdl_tpu.ops import attention_kernel as jak
from bigdl_tpu_torch.interop import load_transformer_lm_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import (LayerNormalization, MultiHeadAttention,
                                ScaledDotProductAttention, cache_commit,
                                cache_write, rope)

VOCAB, EMBED, LAYERS, HEADS = 64, 32, 2, 4
HD = EMBED // HEADS
ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS, n_head=HEADS)
    params = jm.ensure_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS, n_head=HEADS,
                       device="cpu")
    load_transformer_lm_params(tm, tree)
    tm.eval()
    return jm, params, tm


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(
        1, VOCAB + 1, size=shape).astype(np.int32)


class TestCarry:
    def test_every_leaf_is_copied_unchanged(self, models):
        jm, params, tm = models
        np.testing.assert_array_equal(tm.embed.detach().numpy(),
                                      np.asarray(params["embed"]))
        blk = params["block1"]
        np.testing.assert_array_equal(tm.blocks[1].attn.wk.detach().numpy(),
                                      np.asarray(blk["attn"]["wk"]))
        np.testing.assert_array_equal(tm.blocks[1].ln2.bias.detach().numpy(),
                                      np.asarray(blk["ln2"]["bias"]))
        np.testing.assert_array_equal(tm.blocks[0].w2.detach().numpy(),
                                      np.asarray(params["block0"]["w2"]))

    def test_rejects_missing_keys_and_bad_shapes(self, models):
        _, params, _ = models
        tm = TransformerLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS,
                           n_head=HEADS, device="cpu")
        tree = jax.tree_util.tree_map(np.asarray, params)
        del tree["block1"]["attn"]["bo"]
        with pytest.raises(KeyError, match="block1.attn"):
            load_transformer_lm_params(tm, tree)
        tree = jax.tree_util.tree_map(np.asarray, params)
        tree["head"] = tree["head"].T
        with pytest.raises(ValueError, match="head"):
            load_transformer_lm_params(tm, tree)


class TestWholeModel:
    @pytest.mark.parametrize("t", [16, 11])
    def test_full_sequence_log_probs(self, models, t, monkeypatch):
        monkeypatch.setattr(jak, "INTERPRET", True)
        jm, params, tm = models
        toks = _tokens((3, t), seed=t)
        want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, None))(
            params, jnp.asarray(toks)))
        with torch.no_grad():
            got = tm(torch.from_numpy(toks)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_prefill_last_log_probs_and_cache(self, models, monkeypatch):
        """Bucket-padded prefill: row 2 repeats row 1 including its slot
        id, as the engine pads a batch bucket."""
        monkeypatch.setattr(jak, "INTERPRET", True)
        jm, params, tm = models
        toks = np.ones((3, 16), np.int32)
        lengths = np.array([5, 11, 11], np.int32)
        raw = _tokens((2, 11), seed=1)
        toks[0, :5], toks[1, :11] = raw[0, :5], raw[1]
        toks[2] = toks[1]
        slots = np.array([3, 0, 0], np.int32)
        last_j, cache_j = jm.apply_prefill(
            params, jnp.asarray(toks), jm.init_cache(4, 24),
            jnp.asarray(slots), jnp.asarray(lengths))
        cache_t = tm.init_cache(4, 24)
        with torch.no_grad():
            last_t, cache_t = tm.apply_prefill(
                torch.from_numpy(toks), cache_t, torch.from_numpy(slots),
                torch.from_numpy(lengths))
        np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                                   atol=ATOL)
        for kind in ("k", "v"):
            for i in range(LAYERS):
                np.testing.assert_allclose(
                    cache_t[kind][i].numpy(), np.asarray(cache_j[kind][i]),
                    atol=ATOL, err_msg=f"{kind} layer {i}")

    def test_apply_step_every_position_with_mixed_slot_ages(self, models):
        """Slot 1 joins three steps after slot 0; until then it rides
        along at position 0 with token 1, as an idle engine slot does.
        Each active slot's log-probs match the JAX step and the JAX
        full-sequence apply at its position."""
        jm, params, tm = models
        toks = _tokens((2, 9), seed=2)
        full = np.asarray(jm.apply(params, jnp.asarray(toks), None))
        cache_j, cache_t = jm.init_cache(2, 16), tm.init_cache(2, 16)
        step_j = jax.jit(jm.apply_step)
        for step in range(12):
            pos = np.array([min(step, 8), max(step - 3, 0)], np.int32)
            tok = np.array([toks[0, pos[0]],
                            toks[1, pos[1]] if step >= 3 else 1], np.int32)
            logp_j, cache_j = step_j(params, jnp.asarray(tok), cache_j,
                                     jnp.asarray(pos))
            with torch.no_grad():
                logp_t, cache_t = tm.apply_step(
                    torch.from_numpy(tok), cache_t, torch.from_numpy(pos))
            np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j),
                                       atol=ATOL, err_msg=f"step {step}")
            if step < 9:
                np.testing.assert_allclose(logp_t[0].numpy(),
                                           full[0, step], atol=ATOL)
            if 3 <= step:
                np.testing.assert_allclose(logp_t[1].numpy(),
                                           full[1, step - 3], atol=ATOL)

    def test_init_cache_shapes_and_validation(self, models):
        _, _, tm = models
        cache = tm.init_cache(4, 16)
        assert len(cache["k"]) == len(cache["v"]) == LAYERS
        assert cache["k"][0].shape == (4, HEADS, 16, HD)
        with pytest.raises(ValueError):
            tm.init_cache(0, 16)
        with pytest.raises(ValueError):
            tm.init_cache(4, 0)

    def test_max_len_guard(self):
        tm = TransformerLM(VOCAB, embed_dim=EMBED, n_layer=1, n_head=HEADS,
                           max_len=8, device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            tm(torch.ones((1, 9), dtype=torch.long))


class TestLayers:
    @pytest.mark.parametrize("per_row", [False, True])
    def test_rope(self, per_row):
        rs = np.random.RandomState(3)
        x = rs.randn(2, 3, 5, 8).astype(np.float32)
        pos = rs.randint(0, 50, size=(2, 5)) if per_row else None
        want = jattn.rope(jnp.asarray(x),
                          None if pos is None else jnp.asarray(pos))
        got = rope(torch.from_numpy(x),
                   None if pos is None else torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_layer_normalization(self):
        rs = np.random.RandomState(4)
        x = (rs.randn(3, 7, 16) * 3 + 1).astype(np.float32)
        w, b = rs.randn(16).astype(np.float32), rs.randn(16).astype(
            np.float32)
        want = JaxLN(16).apply({"weight": jnp.asarray(w),
                                "bias": jnp.asarray(b)}, jnp.asarray(x),
                               None)
        ln = LayerNormalization(16, device="cpu")
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(w))
            ln.bias.copy_(torch.from_numpy(b))
            got = ln(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_gelu_is_the_tanh_form(self):
        x = np.linspace(-6, 6, 101).astype(np.float32)
        got = torch.nn.functional.gelu(torch.from_numpy(x),
                                       approximate="tanh")
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax.nn.gelu(jnp.asarray(x))),
                                   atol=1e-6)

    def test_cache_write_and_commit_match_jax(self):
        rs = np.random.RandomState(5)
        cache = rs.randn(3, 2, 8, 4).astype(np.float32)
        new = rs.randn(3, 2, 2, 4).astype(np.float32)
        pos = np.array([0, 5, 7], np.int32)  # 7 clamps to 6 (= L - T)
        want = jattn.cache_write(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(pos))
        got = cache_write(torch.from_numpy(cache.copy()),
                          torch.from_numpy(new), torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        slots = np.array([2, 0, 2], np.int32)   # a repeated slot id
        new[2] = new[0]
        want = jattn.cache_commit(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(slots))
        got = cache_commit(torch.from_numpy(cache.copy()),
                           torch.from_numpy(new), slots)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(IndexError):
            cache_commit(torch.from_numpy(cache), torch.from_numpy(new),
                         [0, 1, 3])

    @pytest.mark.parametrize("causal", [False, True])
    def test_mha_self_and_cross_attention(self, causal):
        jm = jattn.MultiHeadAttention(16, 2, causal=causal, use_rope=True,
                                      use_flash=False)
        params = jm.init(jax.random.PRNGKey(1))
        tm = MultiHeadAttention(16, 2, causal=causal, use_rope=True,
                                device="cpu")
        with torch.no_grad():
            for name, value in params.items():
                getattr(tm, name).copy_(torch.tensor(np.asarray(value)))
        rs = np.random.RandomState(6)
        xq = rs.randn(2, 6, 16).astype(np.float32)
        xkv = rs.randn(2, 6, 16).astype(np.float32)
        with torch.no_grad():
            got_self = tm(torch.from_numpy(xq))
            got_cross = tm((torch.from_numpy(xq), torch.from_numpy(xkv)))
        np.testing.assert_allclose(
            got_self.numpy(),
            np.asarray(jm.apply(params, jnp.asarray(xq), None)), atol=1e-5)
        np.testing.assert_allclose(
            got_cross.numpy(),
            np.asarray(jm.apply(params, (jnp.asarray(xq), jnp.asarray(xkv)),
                                None)), atol=1e-5)

    def test_scaled_dot_product_attention_module(self):
        rs = np.random.RandomState(7)
        q, k, v = (torch.from_numpy(rs.randn(1, 2, 9, 8).astype(np.float32))
                   for _ in range(3))
        flash = ScaledDotProductAttention(causal=True)(q, k, v)
        naive = ScaledDotProductAttention(causal=True, use_flash=False)(
            q, k, v)
        np.testing.assert_allclose(flash.numpy(), naive.numpy(), atol=1e-5)
