"""The port on the card: the flash forward CUDA kernel against its plain
version, and the generation engine on CUDA against the CPU.

Every test here needs a CUDA device and skips without one. This file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 1e-4 on O and lse (the same f32 terms summed in
another order, ~1e-6 apart in practice); bf16 atol 2e-2 on O, which the
kernel rounds to bf16, and 1e-4 on the f32 lse.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import attention_kernel as tak
from bigdl_tpu_torch.serving import GenerationEngine, greedy_decode_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol_o", [(torch.float32, 1e-4),
                                          (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,tq,tk,d,k_offset", [
    (True, 128, 128, 64, 0), (True, 1000, 1000, 64, 0),
    (False, 1000, 1500, 64, 0), (True, 256, 256, 128, 0),
    (False, 100, 70, 40, 0), (True, 128, 128, 64, 64)])
def test_kernel_matches_plain(cuda_device, dtype, atol_o, causal, tq, tk,
                              d, k_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(tq + d)
    q = torch.randn((2, 4, tq, d), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, 4, tk, d), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = tak.flash_attention_forward.launches
    o, lse = tak.flash_attention_forward(q, k, v, causal=causal,
                                         return_lse=True, k_offset=k_offset)
    torch.cuda.synchronize()
    assert tak.flash_attention_forward.launches == before + 1
    o_ref, lse_ref = tak.flash_attention_forward_plain(
        q, k, v, causal, k_offset=k_offset)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol_o, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    if k_offset:  # rows before the first key see nothing: O = 0, lse = 0
        assert (o[:, :, :k_offset] == 0).all()
        assert (lse[:, :, :k_offset] == 0).all()


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn((1, 2, 16, 160), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tak.flash_attention_forward(q, q, q)
    q = torch.randn((1, 2, 16, 32), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tak.flash_attention_forward(q.transpose(2, 3).contiguous()
                                    .transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        tak.flash_attention_forward(q.half(), q.half(), q.half())
    with pytest.raises(NotImplementedError, match="backward"):
        tak.flash_attention_forward(q.requires_grad_(), q, q)


def test_engine_on_cuda_matches_cpu_reference(cuda_device):
    """Prefill goes through the kernel (one launch per layer per prefill
    batch); the greedy tokens equal the CPU full-recompute reference on the
    same weights wherever its top-2 margin exceeds 1e-4."""
    cfg = dict(vocab_size=64, embed_dim=64, n_layer=2, n_head=4)
    cpu = TransformerLM(**cfg, device="cpu")
    gpu = TransformerLM(**cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 65, size=n).astype(np.int32)
               for n in (3, 9, 17, 30, 5, 60)]
    before = tak.flash_attention_forward.launches
    with GenerationEngine(gpu, slots=4, max_len=128, max_new_tokens=8,
                          device=cuda_device) as eng:
        got = [s.result(120) for s in [eng.generate(p) for p in prompts]]
        batches = eng.generation_stats()["prefill_batches"]
    assert tak.flash_attention_forward.launches - before == batches * 2
    for p, toks in zip(prompts, got):
        ref = greedy_decode_reference(cpu, p, 8)
        seq = torch.from_numpy(np.concatenate([p, ref[:-1]])[None])
        with torch.inference_mode():
            top2 = cpu(seq)[0, p.size - 1:].topk(2).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        n = next((i for i, m in enumerate(margins) if m < 1e-4), len(ref))
        assert toks[:n] == ref[:n]
