"""The port on the card: the flash forward, the flash carry (the ring
hop), the flash backward (dq and dk/dv), the BN+ReLU and the
space-to-depth stem CUDA kernels against their plain versions, the
stem layer's kernel route against its cuDNN route, the generation engine
on CUDA against the CPU, a ResNet training step through the kernels
against the CPU, an LM training step's kernel launches, and ring, zigzag
and Ulysses attention over 4 shards on one card against kernel 1.

Every test here needs a CUDA device and skips without one. This file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 1e-4 on O and lse (the same f32 terms summed in
another order, ~1e-6 apart in practice); bf16 atol 2e-2 on O, which the
kernel rounds to bf16, and 1e-4 on the f32 lse. BN+ReLU: forward and
dx bitwise (the same roundings in the same order); dscale/dshift within
1e-5 times the sum of the terms' magnitudes per channel (another
summation order). Flash backward, per element: |kernel - plain| <=
1e-4 * max|plain| in f32 (another summation order), plus 2**-7 * |plain|
in bf16 (each rounds the gradient to nearest bf16, at most one ulp
apart; bf16 runs on the tensor cores with P and dS split into bf16 hi +
lo, f32 on the CUDA cores); a second launch gives the same bits. Flash carry: acc within
1e-5 * max|plain|, m and l within 1e-5 * max(|plain|, 1) (f32 math in
both, another summation order; bf16 runs on the tensor cores with P split
into bf16 hi + lo, f32 on the CUDA cores); a shard wholly in the queries'
future passes the carry through bitwise. Sequence parallel: per element 1e-4 *
max|ref| of kernel 1 on the whole sequence, plus one bf16 ulp in bf16.
Stem (kernel 5): per element 1e-5 * max|plain| in f32 (the same f32
products summed in another order), plus one bf16 ulp, 2**-7 * |plain|, in
bf16 (each rounds its f32 sum to nearest); a second launch gives the same
bits. Kernels 1 and 5 in bf16 (with O % 8 == 0 for kernel 5) run their
tensor-core designs, in f32 their CUDA-core ones; bf16 inputs 2 bytes past
a 16-byte boundary take element-wise copies and give the same bits.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models import ResNet, TransformerLM
from bigdl_tpu_torch.ops import attention_kernel as tak
from bigdl_tpu_torch.ops import bn_relu_kernel as tbk
from bigdl_tpu_torch.ops import stem_kernel as tsk
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
    (False, 100, 70, 40, 0), (True, 128, 128, 64, 64),
    (True, 100, 70, 36, 0)])
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


def _offset_view(x):
    """x's values in a contiguous view 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    out = buf[1:].view(x.shape)
    assert out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,tk,d,k_offset", [
    (True, 1000, 1000, 64, 0), (False, 300, 300, 40, 0),
    (True, 256, 256, 128, 0), (True, 128, 128, 64, 64)])
def test_kernel_second_launch_is_bitwise_equal(cuda_device, dtype, causal,
                                               tq, tk, d, k_offset):
    """Each block owns its rows and sums in a fixed order (no atomics), in
    both designs: the same bits on every launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk + d)
    q = torch.randn((2, 4, tq, d), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, 4, tk, d), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, return_lse=True, k_offset=k_offset)
    first = tak.flash_attention_forward(q, k, v, **kw)
    again = tak.flash_attention_forward(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("causal,t,d", [(True, 200, 64), (False, 300, 40),
                                        (True, 130, 128)])
def test_kernel_takes_unaligned_rows(cuda_device, causal, t, d):
    """bf16 q, k, v that start 2 bytes past a 16-byte boundary (contiguous
    views into a larger buffer) take the tensor-core design's element-wise
    copies: the same bits as the 16-byte copies of aligned tensors."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + d)
    aligned = [torch.randn((2, 4, t, d), generator=gen, device=cuda_device
                           ).bfloat16() for _ in range(3)]
    shifted = [_offset_view(x) for x in aligned]
    outs = [tak.flash_attention_forward(*xs, causal, return_lse=True)
            for xs in (aligned, shifted)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    o_ref, lse_ref = tak.flash_attention_forward_plain(*aligned, causal)
    torch.testing.assert_close(outs[1][0].float(), o_ref.float(), atol=2e-2,
                               rtol=0)
    torch.testing.assert_close(outs[1][1], lse_ref, atol=1e-4, rtol=0)


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


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("x_dt,y_dt", [(torch.float32, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,c", [(7, 5), (1, 129), (16, 130), (2, 12),
                                 (3000, 64), (200, 512)])
def test_bn_relu_kernels_match_plain(cuda_device, n, c, x_dt, y_dt, relu):
    gen = torch.Generator(device=cuda_device).manual_seed(n * c)
    x = torch.randn((n, c), generator=gen, device=cuda_device).to(x_dt)
    s = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    b = torch.randn((c,), generator=gen, device=cuda_device) * 0.5
    g = torch.randn((n, c), generator=gen, device=cuda_device).to(y_dt)
    f0, b0 = tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches
    y = tbk.bn_relu_forward(x, s, b, relu, y_dt)
    dx, ds, db = tbk.bn_relu_backward(x, s, b, g, relu)
    torch.cuda.synchronize()
    assert (tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches) \
        == (f0 + 1, b0 + 1)
    assert y.dtype == y_dt and dx.dtype == torch.float32
    assert torch.equal(y, tbk.bn_relu_forward_plain(x, s, b, relu, y_dt))
    dx_ref, ds_ref, db_ref = tbk.bn_relu_backward_plain(x, s, b, g, relu)
    assert torch.equal(dx, dx_ref)
    gm = g.float()
    if relu:
        gm = torch.where((x * s + b).to(y_dt) > 0, gm, 0.0)
    assert ((ds - ds_ref).abs() <= 1e-5 * (gm * x.float()).abs().sum(0)).all()
    assert ((db - db_ref).abs() <= 1e-5 * gm.abs().sum(0)).all()
    # the partial-sum tiling is fixed by (N, C): the same bits every run
    dx2, ds2, db2 = tbk.bn_relu_backward(x, s, b, g, relu)
    assert torch.equal(ds, ds2) and torch.equal(db, db2)


def test_bn_relu_kernels_reject_strided_input(cuda_device):
    s = torch.ones(6, device=cuda_device)
    b = torch.zeros(6, device=cuda_device)
    x = torch.randn((8, 6), device=cuda_device)
    strided = torch.randn((6, 8), device=cuda_device).t()  # [8, 6] col-major
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu_forward(strided, s, b)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu_backward(x, s, b, strided)
    # an NCHW-contiguous activation seen as NHWC is not channels_last
    nhwc = torch.randn((2, 6, 2, 2), device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu(nhwc, s, b)
    with pytest.raises(ValueError, match="on"):
        tbk.bn_relu_forward(x, s.cpu(), b)


def test_resnet_step_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """One f32 training-mode forward and backward of CIFAR ResNet-8 through
    the kernels (4 fused sites) against the same model on the CPU (the
    plain versions): loss and every gradient agree."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cpu = ResNet(10, depth=8, data_set="cifar10", device="cpu")
    gpu = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(4, 16, 16, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, size=4).astype(np.int64))
    f0, b0 = tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        out = m(x.to(dev))
        loss = -out.gather(1, y.to(dev)[:, None]).mean()
        loss.backward()
        losses.append(loss.item())
    assert (tbk.bn_relu_forward.launches - f0,
            tbk.bn_relu_backward.launches - b0) == (4, 4)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4,
                                   rtol=1e-3, msg=name)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("causal,tq,tk,d,q_offset", [
    (True, 128, 128, 64, 0), (True, 1000, 1000, 64, 0),
    (False, 1000, 1500, 64, 0), (True, 256, 256, 128, 0),
    (False, 100, 70, 40, 0), (True, 256, 256, 64, -64),
    (True, 2048, 2048, 64, 0), (True, 100, 70, 36, 0)])
def test_flash_backward_kernels_match_plain(cuda_device, dtype, rtol, causal,
                                            tq, tk, d, q_offset):
    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk + d)
    q, do = (torch.randn((2, 4, tq, d), generator=gen, device=cuda_device
                         ).to(dtype) for _ in range(2))
    k, v = (torch.randn((2, 4, tk, d), generator=gen, device=cuda_device
                        ).to(dtype) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = tak.flash_attention_forward(q, k, v, return_lse=True, **kw)
    delta = tak.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    before = (tak.flash_attention_backward_dq.launches,
              tak.flash_attention_backward_dkv.launches)
    got = (tak.flash_attention_backward_dq(*args, **kw),
           *tak.flash_attention_backward_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert (tak.flash_attention_backward_dq.launches,
            tak.flash_attention_backward_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    pargs = (*args, causal, d ** -0.5, q_offset, 0)
    want = (tak.flash_attention_backward_dq_plain(*pargs),
            *tak.flash_attention_backward_dkv_plain(*pargs))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        w = w.float()
        lim = rtol * w.abs() + 1e-4 * w.abs().max()
        assert bool(((g.float() - w).abs() <= lim).all())
    if q_offset < 0:  # rows before the first key see nothing: dq = 0
        assert (got[0][:, :, :-q_offset] == 0).all()
    # each block owns its rows and sums in a fixed order: the same bits
    again = (tak.flash_attention_backward_dq(*args, **kw),
             *tak.flash_attention_backward_dkv(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_backward_kernels_take_unaligned_rows(cuda_device):
    """bf16 inputs and outputs that start 2 bytes past a 16-byte boundary
    (contiguous views into a larger buffer) take the kernels' element-wise
    copies: the same bits as the 16-byte copies of aligned tensors."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    shape = (2, 4, 200, 64)
    n = np.prod(shape)
    aligned = [torch.randn(shape, generator=gen, device=cuda_device
                           ).bfloat16() for _ in range(4)]
    shifted = []
    for x in aligned:
        buf = torch.empty(n + 1, dtype=torch.bfloat16, device=cuda_device)
        buf[1:].copy_(x.reshape(-1))
        shifted.append(buf[1:].view(shape))
    assert all(x.data_ptr() % 16 == 2 for x in shifted)
    outs = []
    for q, k, v, do in (aligned, shifted):
        o, lse = tak.flash_attention_forward(q, k, v, True, return_lse=True)
        delta = tak.attention_delta(o, do)
        outs.append((tak.flash_attention_backward_dq(
            q, k, v, do, lse, delta, True),
            *tak.flash_attention_backward_dkv(q, k, v, do, lse, delta,
                                              True)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_naive_autograd(cuda_device, causal):
    """The autograd.Function (kernels 1, 3, 4) against naive attention
    through autograd, f32 at a tiny shape; dO reaches the Function
    non-contiguous (the loss reads O through a transpose)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    base = [torch.randn((2, 3, 37, 16), generator=gen, device=cuda_device)
            for _ in range(3)]
    w = torch.randn((2, 37, 3, 16), generator=gen, device=cuda_device)
    grads = []
    for fn in (tak.flash_attention, tak.naive_attention):
        xs = [x.clone().requires_grad_() for x in base]
        (fn(*xs, causal).transpose(1, 2) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-4)


def test_lm_training_step_launches_each_kernel_once_a_layer(cuda_device):
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    model = TransformerLM(64, embed_dim=64, n_layer=2, n_head=4,
                          device=cuda_device)
    x = torch.randint(1, 65, (2, 100), device=cuda_device)
    y = torch.randint(1, 65, (2, 100), device=cuda_device)
    counters = (tak.flash_attention_forward, tak.flash_attention_backward_dq,
                tak.flash_attention_backward_dkv)
    before = [f.launches for f in counters]
    loss = TimeDistributedCriterion(ClassNLLCriterion())(model(x), y)
    loss.backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 2]
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


# kernel 2 against its plain version: acc within CARRY_TOL * max|plain|,
# m and l within CARRY_TOL * max(|plain|, 1) per element. In f32 both sum
# the same f32 terms in another order; in bf16 both take S as exact
# products summed in f32, and the kernel carries P as bf16 hi + lo
# (0.12-0.19 of this limit in the CPU emulation of
# tests/test_torch_attention_kernel.py).
CARRY_TOL = 1e-5


def _random_carry(q, k0, v0, masked_rows=0):
    """A carried (acc, m, l): the plain hop over keys k0, v0 (non-causal),
    with the first `masked_rows` rows still fully masked."""
    acc, m, l = tak.flash_attention_carry_plain(
        q, k0, v0, tak.attention_state_init(q))
    acc[:, :, :masked_rows] = 0
    m[:, :, :masked_rows] = tak.NEG_INF
    l[:, :, :masked_rows] = 0
    return acc, m, l


def _assert_carry_close(got, want):
    acc, m, l = got
    r_acc, r_m, r_l = want
    assert float((acc - r_acc).abs().max()) <= \
        CARRY_TOL * float(r_acc.abs().max())
    for a, b in ((m, r_m), (l, r_l)):
        assert bool(((a - b).abs() <= CARRY_TOL * b.abs().clamp(min=1)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,d,causal,q_offset,k_offset,masked", [
    (256, 256, 64, True, 256, 256, 0),     # diagonal hop
    (256, 256, 64, True, 512, 0, 0),       # below the diagonal
    (2048, 2048, 64, True, 2048, 0, 0),    # the ring's hop, B*H = 8 as B1 H8
    (200, 136, 64, True, 300, 200, 0),     # ragged Tq / Tk
    (128, 128, 128, True, 0, 16, 32),      # rows still fully masked
    (100, 70, 40, False, 0, 0, 0)])        # padded head dim
def test_carry_kernel_matches_plain(cuda_device, dtype, tq, tk, d, causal,
                                    q_offset, k_offset, masked):
    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk + d)
    q = torch.randn((2, 4, tq, d), generator=gen, device=cuda_device)
    k, v, k0, v0 = (torch.randn((2, 4, tk, d), generator=gen,
                                device=cuda_device) for _ in range(4))
    q, k, v, k0, v0 = (x.to(dtype) for x in (q, k, v, k0, v0))
    carry = _random_carry(q, k0, v0, masked)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    before = tak.flash_attention_carry.launches
    got = tak.flash_attention_carry(q, k, v, carry, **kw)
    torch.cuda.synchronize()
    assert tak.flash_attention_carry.launches == before + 1
    _assert_carry_close(got, tak.flash_attention_carry_plain(q, k, v, carry,
                                                            **kw))
    if masked:  # rows 0-15 see no key in this hop either: still masked
        assert (got[1][:, :, :16] == tak.NEG_INF).all()
        assert (got[2][:, :, :16] == 0).all()
        assert (got[0][:, :, :16] == 0).all()
    again = tak.flash_attention_carry(q, k, v, carry, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # in place: the outputs are the carry's own tensors
    inplace = tak.flash_attention_carry(q, k, v, carry, inplace=True, **kw)
    assert all(a is b for a, b in zip(inplace, carry))
    assert all(torch.equal(a, b) for a, b in zip(carry, got))


def test_carry_kernel_passes_a_future_shard_through_bitwise(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, k0, v0 = (torch.randn((2, 4, 192, 64), generator=gen,
                                   device=cuda_device) for _ in range(5))
    carry = _random_carry(q, k0, v0)
    # queries 0..191 against keys 192..383: wholly in their future
    got = tak.flash_attention_carry(q, k, v, carry, causal=True,
                                    q_offset=0, k_offset=192)
    assert all(torch.equal(a, b) for a, b in zip(got, carry))
    # wholly in the past: causal=True equals causal=False
    past = tak.flash_attention_carry(q, k, v, carry, causal=True,
                                     q_offset=192, k_offset=0)
    full = tak.flash_attention_carry(q, k, v, carry, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(past, full))


@pytest.mark.parametrize("dtype,kernel,other", [
    (torch.bfloat16, "flash_carry_tc_kernel<", "flash_carry_kernel<"),
    (torch.float32, "flash_carry_kernel<", "flash_carry_tc_kernel<")])
def test_carry_hop_runs_its_dtypes_design(cuda_device, dtype, kernel,
                                          other):
    """A bf16 hop launches the tensor-core kernel and an f32 hop the
    CUDA-core one, by the names the profiler records."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v = (torch.randn((1, 8, 256, 64), generator=gen,
                           device=cuda_device).to(dtype) for _ in range(3))
    carry = tak.attention_state_init(q)
    tak.flash_attention_carry(q, k, v, carry, causal=True)  # builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tak.flash_attention_carry(q, k, v, carry, causal=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-4)])
def test_two_carry_hops_equal_kernel_one(cuda_device, dtype, atol):
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = (torch.randn((2, 4, 384, 64), generator=gen,
                           device=cuda_device).to(dtype) for _ in range(3))
    state = tak.attention_state_init(q)
    for k_off in (0, 192):
        sl = slice(k_off, k_off + 192)
        state = tak.flash_attention_carry(
            q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(), state,
            causal=True, k_offset=k_off)
    out = tak.attention_state_finish(*state)
    want = tak.flash_attention_forward(q.float(), k.float(), v.float(),
                                       causal=True)
    torch.testing.assert_close(out, want, atol=atol, rtol=0)


def test_carry_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn((1, 2, 16, 32), device=cuda_device)
    carry = tak.attention_state_init(q)
    with pytest.raises(NotImplementedError, match="backward"):
        tak.flash_attention_carry(q.clone().requires_grad_(), q, q, carry)
    wide = torch.randn((1, 2, 16, 160), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tak.flash_attention_carry(wide, wide, wide,
                                  tak.attention_state_init(wide))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_parallel_on_one_card_matches_kernel_one(cuda_device,
                                                          dtype):
    """Ring, zigzag and Ulysses over 4 shards on one card against kernel 1
    over the whole sequence; kernel 2 launches n^2 = 16 times for the
    ring, n(2n+1) = 36 for zigzag and never for Ulysses."""
    from bigdl_tpu_torch.parallel import (build_mesh,
                                          make_sequence_parallel_attention)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn((1, 4, 512, 64), generator=gen,
                           device=cuda_device).to(dtype) for _ in range(3))
    want = tak.flash_attention_forward(q, k, v, causal=True).float()
    mesh = build_mesh(data=4, devices=[cuda_device] * 4)
    for scheme, launches in (("ring", 16), ("zigzag", 36), ("ulysses", 0)):
        before = tak.flash_attention_carry.launches
        out = make_sequence_parallel_attention(mesh, scheme,
                                               causal=True)(q, k, v)
        torch.cuda.synchronize()
        assert tak.flash_attention_carry.launches - before == launches
        assert out.dtype == dtype and out.device == q.device
        lim = (2 ** -7 if dtype == torch.bfloat16 else 0) * want.abs() \
            + 1e-4 * want.abs().max()
        assert bool(((out.float() - want).abs() <= lim).all()), scheme


def _stem_inputs(device, b, h2, w2, cin, n_out, k, dtype, with_bias, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    kt = (k + 1) // 2
    front = ((k - 1) // 2 + 1) // 2
    x2 = torch.randn((b, h2, w2, 4 * cin), generator=gen, device=device)
    wk = torch.randn((kt, kt, 4 * cin, n_out), generator=gen,
                     device=device) * 0.2
    bias = torch.randn((n_out,), generator=gen, device=device) \
        if with_bias else None
    return x2.to(dtype), wk.to(dtype), bias, front, kt - 1 - front


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,cin,n_out", [(3, 1, 64), (3, 3, 64), (7, 1, 64),
                                         (7, 3, 64), (11, 1, 64),
                                         (11, 3, 64), (7, 3, 72), (7, 4, 3)])
def test_stem_kernel_matches_plain(cuda_device, k, cin, n_out, dtype,
                                   with_bias):
    """Ragged x2 (an input of 226x230), partial channel chunks (O = 72)
    and O % 4 != 0 (O = 3)."""
    x2, wk, bias, front, rear = _stem_inputs(
        cuda_device, 2, 113, 115, cin, n_out, k, dtype, with_bias, k + cin)
    before = tsk.stem_conv_forward.launches
    out = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    again = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    torch.cuda.synchronize()
    assert tsk.stem_conv_forward.launches == before + 2
    assert out.dtype == dtype and out.shape == (2, 113, 115, n_out)
    assert torch.equal(out, again)
    ref = tsk.stem_conv_forward_plain(x2, wk, bias, front, rear).float()
    lim = (2 ** -7 if dtype == torch.bfloat16 else 0) * ref.abs() \
        + 1e-5 * ref.abs().max()
    assert bool(((out.float() - ref).abs() <= lim).all())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin", [1, 3])
def test_stem_tensor_core_design_at_resnet_width(cuda_device, cin,
                                                 with_bias):
    """bf16 x2 and wk with O = 64 run the tensor-core design: at
    ResNet-50's x2 of 112x112 (k = 7), within one bf16 ulp plus 1e-5 *
    max|plain| of the plain version, the same bits on a second launch, and
    the same bits from an x2 2 bytes past a 16-byte boundary (the
    element-wise halo copies)."""
    x2, wk, bias, front, rear = _stem_inputs(
        cuda_device, 4, 112, 112, cin, 64, 7, torch.bfloat16, with_bias,
        40 + cin)
    out = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    again = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    shifted = tsk.stem_conv_forward(_offset_view(x2), wk, bias, front, rear)
    assert torch.equal(out, again) and torch.equal(out, shifted)
    ref = tsk.stem_conv_forward_plain(x2, wk, bias, front, rear).float()
    lim = 2 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
    assert bool(((out.float() - ref).abs() <= lim).all())


def test_stem_kernel_rejects_what_it_does_not_take(cuda_device):
    x2 = torch.zeros((1, 8, 8, 20), device=cuda_device)
    with pytest.raises(ValueError, match="C2 <= 16"):
        tsk.stem_conv_forward(x2, torch.zeros((4, 4, 20, 8),
                                              device=cuda_device), None, 2, 1)
    x2 = torch.zeros((1, 8, 8, 12), device=cuda_device)
    with pytest.raises(ValueError, match="kt in"):
        tsk.stem_conv_forward(x2, torch.zeros((3, 3, 12, 8),
                                              device=cuda_device), None, 1, 1)
    with pytest.raises(ValueError, match="on"):
        tsk.stem_conv_forward(x2, torch.zeros((4, 4, 12, 8)), None, 2, 1)


def test_stem_layer_on_cuda_runs_the_kernel_never_the_plain(cuda_device,
                                                            monkeypatch):
    """The layer with `pallas_stem=True` on a CUDA tensor launches the
    kernel once a forward and never calls the plain version; its output
    and gradients match the cuDNN stride-2 route (`pallas_stem=False`)."""
    from bigdl_tpu_torch.nn import SpaceToDepthStemConvolution
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    calls = {"n": 0}

    def refuse(*a, **kw):
        calls["n"] += 1
        raise AssertionError("the plain stem ran on a CUDA tensor")
    monkeypatch.setattr(tsk, "stem_conv_forward_plain", refuse)
    kernel = SpaceToDepthStemConvolution(3, 64, 7, with_bias=True,
                                         pallas_stem=True,
                                         device=cuda_device)
    cudnn = SpaceToDepthStemConvolution(3, 64, 7, with_bias=True,
                                        pallas_stem=False,
                                        device=cuda_device)
    cudnn.load_state_dict(kernel.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand((4, 64, 64, 3), generator=gen, device=cuda_device)
    w = torch.randn((4, 32, 32, 64), generator=gen, device=cuda_device)
    grads = []
    for m in (kernel, cudnn):
        before = tsk.stem_conv_forward.launches
        xg = x.clone().requires_grad_()
        out = m(xg)
        (out * w).sum().backward()
        grads.append((out.detach(), xg.grad, m.weight.grad, m.bias.grad))
        assert tsk.stem_conv_forward.launches - before == int(m is kernel)
    assert calls["n"] == 0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
