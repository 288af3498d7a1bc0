"""The port on the card: the flash forward, the flash carry (the ring
hop), the flash backward (dq and dk/dv), the BN+ReLU and the
space-to-depth stem CUDA kernels against their plain versions, the
stem layer's kernel route against its cuDNN route, the generation engine
on CUDA against the CPU, a ResNet training step through the kernels
against the CPU, an LM training step's kernel launches, ring, zigzag
and Ulysses attention over 4 shards on one card against kernel 1, and
the training loop's accounting and safety net: one FLOP count of a step
whether the kernels run (the card), their plain versions (the CPU) or
neither (the meta device), the Evaluator on the card against the CPU,
and a resume from a checkpoint equal to the uninterrupted run bit for bit
(deterministic algorithms on); data parallel: two ranks over gloo
sharing the card against one process on the whole batch; and the
Wide&Deep sparse stack: `LookupTableSparse` and `SparseLinear` on the
card against their CPU run (outputs and gradients within 1e-5 of the
largest element, f32), `SparseLinear` and `IndicatorCol` given the
card's index tensors; and the pipelines: 1F1B over a "pipe" mesh that
repeats the card against its microbatch oracle with kernels 6-7's
launches a step, `MoE.expert_parallel_apply` against
`dense_capacity_apply`, `DistriPredictor` against `LocalPredictor`;
and the operations stack: a run fed by `set_prefetch` (pinned batches,
`non_blocking` copies) against the serial run bit for bit, with its
`compile` record; model files written on the card and loaded on the CPU
and the other way round, and a fleet replay's canonical streams
identical at one seed; and `nn.Graph`: a ResNet-8 as a Graph launching
kernels 6-7 at its Sequential's count with the same bits, and
`set_graph_optimizations` putting kernel 5 into a Graph's training; and
`Remat`: a ResNet-18 with `remat=True` the same bits as its twin, kernel
6 launching again for the in-block sites in the recompute, and a GRU on
the card against the CPU (1e-5 of each tensor's largest element).

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
Evaluator: the Top1/Top5 counts equal and the loss within a relative
1e-5 (f32, TF32 off, another summation order; the rows' top-2 margins
exceed 1e-3, checked). Stem (kernel 5): per element 1e-5 * max|plain|
in f32 (the same f32 products summed in another order), plus one bf16
ulp, 2**-7 * |plain|, in bf16 (each rounds its f32 sum to nearest); a
second launch gives the same bits. Kernels 1 and 5 in bf16 (with O % 8
== 0 for kernel 5) run their tensor-core designs, in f32 their CUDA-core
ones; bf16 inputs 2 bytes past a 16-byte boundary take element-wise
copies and give the same bits. The zoo's shapes: kernel 5 with its bias
at Inception-v1's b64, and kernel 7 given a channel slice of a `Concat`
gradient at Inception-v2's and `VggForCifar10`'s sites, read in place
with the tolerances above, and one device kernel a backward call.
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
    # a row-strided g (rows 10 apart, columns contiguous) is read in place
    rows = torch.randn((8, 10), device=cuda_device)[:, 2:8]
    dx, ds, db = tbk.bn_relu_backward(x, s, b, rows)
    dx_ref, _, _ = tbk.bn_relu_backward_plain(x, s, b, rows)
    assert torch.equal(dx, dx_ref)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_with_bias_at_inception_v1_shape(cuda_device, dtype):
    """Inception-v1's s2d stem at b64 (x2 [64, 112, 112, 12], O = 64) with
    its bias. In bf16 training the bias reaches the wrapper as the bf16
    copy of the f32 master, as the weight does, and the kernel adds it in
    f32: within one bf16 ulp plus 1e-5 * max|plain| of the plain version
    given the same bf16 bias, and the same bits on a second launch."""
    x2, wk, bias, front, rear = _stem_inputs(
        cuda_device, 64, 112, 112, 3, 64, 7, dtype, True, 64)
    bias = bias.to(dtype)
    out = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    again = tsk.stem_conv_forward(x2, wk, bias, front, rear)
    assert out.dtype == dtype and torch.equal(out, again)
    ref = tsk.stem_conv_forward_plain(x2, wk, bias, front, rear).float()
    lim = (2 ** -7 if dtype == torch.bfloat16 else 0) * ref.abs() \
        + 1e-5 * ref.abs().max()
    assert bool(((out.float() - ref).abs() <= lim).all())


@pytest.mark.parametrize("shape,offset,width", [
    ((32, 7, 7, 352), 0, 1024),     # Inception-v2's 5b 1x1 branch
    ((32, 28, 28, 96), 64, 256),    # a 3a/3b 3x3 branch
    ((32, 512), 256, 1024),         # VggForCifar10's 1-D BN
])
def test_bn_relu_backward_takes_a_concat_gradient_slice(cuda_device, shape,
                                                        offset, width):
    """The fused tail inside a `Concat`: the gradient reaching it is a
    channel slice of the joined gradient (not contiguous), which kernel 7
    reads in place with its row stride: no copy (`g_copies`), one launch.
    dx, dscale, dshift against the plain backward on the same slice: dx
    bitwise, the sums within 1e-5 of the terms' magnitudes per channel,
    and the same bits as the kernel on the contiguous copy (the partition
    depends on (N, C) alone); also at an offset that breaks the 16-byte
    alignment (element-wise loads)."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda_device)
    s = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    b = torch.randn((c,), generator=gen, device=cuda_device) * 0.5
    x.requires_grad_()
    s.requires_grad_()
    b.requires_grad_()
    full = torch.randn((*shape[:-1], width + 1), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    for off in (offset, offset + 1):
        y = tbk.bn_relu(x, s, b, True, torch.bfloat16)
        g = full[..., off:off + c]
        assert not g.is_contiguous()
        copies = tbk.BnReluFunction.g_copies
        launches = tbk.bn_relu_backward.launches
        dx, ds, db = torch.autograd.grad(y, (x, s, b), g)
        assert tbk.BnReluFunction.g_copies == copies
        assert tbk.bn_relu_backward.launches == launches + 1
        x2, g2 = x.detach().reshape(-1, c), g.contiguous().reshape(-1, c)
        dx_ref, ds_ref, db_ref = tbk.bn_relu_backward_plain(
            x2, s.detach(), b.detach(), g2, True)
        assert torch.equal(dx.reshape(-1, c), dx_ref)
        gm = torch.where(
            (x2 * s.detach() + b.detach()).to(torch.bfloat16) > 0,
            g2.float(), 0.0)
        assert ((ds - ds_ref).abs() <= 1e-5 * (gm * x2).abs().sum(0)).all()
        assert ((db - db_ref).abs() <= 1e-5 * gm.abs().sum(0)).all()
        _, ds_c, db_c = tbk.bn_relu_backward(x2, s.detach(), b.detach(),
                                             g2, True)
        assert torch.equal(ds, ds_c) and torch.equal(db, db_c)


@pytest.mark.parametrize("x_dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", [(128 * 112 * 112, 64), (32 * 7 * 7, 352)])
def test_bn_relu_backward_is_one_device_kernel(cuda_device, n, c, x_dt):
    """Kernel 7 sums dscale and dshift inside its one launch: the profiler
    sees exactly one device kernel a call (after a first call, which may
    zero the ticket counters once), at ResNet-50's stem site and
    Inception-v2's 7x7 C=352 site."""
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.tools.bench import (close_profile_window,
                                             is_profile_marker,
                                             open_profile_window)
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    x = torch.randn((n, c), generator=gen, device=cuda_device).to(x_dt)
    s = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    b = torch.randn((c,), generator=gen, device=cuda_device) * 0.5
    g = torch.randn((n, c), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    tbk.bn_relu_backward(x, s, b, g, True)
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_profile_window()
        for _ in range(calls):
            tbk.bn_relu_backward(x, s, b, g, True)
        close_profile_window()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not is_profile_marker(e.name)]
    assert len(kernels) == calls, kernels
    assert all("bn_relu_bwd" in k for k in kernels), kernels


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


def _small_step(make, x, y, crit, device):
    """`costs.count_flops` of one real step of `make(device)` on (x, y),
    and the optimizer (for `step_flops`)."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.observability import costs
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer
    model = make(device)
    opt = DistriOptimizer(model, LocalDataSet([MiniBatch(x, y)]), crit,
                          devices=[device])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    state = opt.optim_method.init_state_with_masters(
        dict(model.named_parameters()))
    return costs.count_flops(opt._build_step(), state,
                             torch.from_numpy(x).to(device),
                             torch.from_numpy(y).to(device), 0.01), opt


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_step_count_is_one_number_on_card_cpu_and_meta(cuda_device, model):
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.tools.bench import step_flops
    rs = np.random.RandomState(5)
    if model == "resnet":
        def make(dev):
            return ResNet(10, depth=8, data_set="cifar10", device=dev)
        x = rs.rand(4, 16, 16, 3).astype(np.float32)
        y = (rs.randint(0, 10, 4) + 1).astype(np.int32)
        crit = ClassNLLCriterion()
    else:
        def make(dev):
            return TransformerLM(64, embed_dim=64, n_layer=2, n_head=2,
                                 device=dev)
        x, y = (rs.randint(1, 65, (2, 64)).astype(np.int32)
                for _ in range(2))
        crit = TimeDistributedCriterion(ClassNLLCriterion())
    launches = (tbk.bn_relu_backward.launches,
                tak.flash_attention_backward_dkv.launches)
    card, _ = _small_step(make, x, y, crit, cuda_device)
    assert (tbk.bn_relu_backward.launches,
            tak.flash_attention_backward_dkv.launches) != launches
    cpu, opt = _small_step(make, x, y, crit, torch.device("cpu"))
    assert card == cpu == step_flops(opt)


def test_evaluator_on_the_card_matches_the_cpu(cuda_device):
    import copy
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import (Evaluator, Loss, Top1Accuracy,
                                       Top5Accuracy)
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(2)
    x = rs.rand(20, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, 20) + 1).astype(np.int32)
    samples = [Sample(x[i], y[i]) for i in range(20)]
    model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device,
                   generator=torch.Generator().manual_seed(3))
    cpu_model = copy.deepcopy(model).cpu()
    methods = lambda: [Top1Accuracy(), Top5Accuracy(), Loss()]  # noqa
    card = Evaluator(model, 8).test(samples, methods())
    cpu_ev = Evaluator(cpu_model, 8, device="cpu")
    cpu = cpu_ev.test(samples, methods())
    out = cpu_ev._pred._forward(torch.from_numpy(x))
    top = torch.topk(out, 6, dim=-1).values
    assert float((top[:, 0] - top[:, 1]).min()) > 1e-3
    assert float((top[:, 4] - top[:, 5]).min()) > 1e-3
    assert card[0].result() == cpu[0].result()
    assert card[1].result() == cpu[1].result()
    np.testing.assert_allclose(card[2].result()[0], cpu[2].result()[0],
                               rtol=1e-5)


def test_resume_on_the_card_equals_the_uninterrupted_run(cuda_device,
                                                         tmp_path):
    import shutil
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, max_iteration,
                                       several_iteration)
    rs = np.random.RandomState(4)
    batches = [MiniBatch(torch.from_numpy(rs.rand(8, 16, 16, 3).astype(
        np.float32)).to(cuda_device), torch.from_numpy(
        (rs.randint(0, 10, 8) + 1).astype(np.int32)).to(cuda_device))
        for _ in range(3)]

    def run(path, resume):
        model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device,
                       generator=torch.Generator().manual_seed(0))
        opt = DistriOptimizer(model, LocalDataSet(batches, seed=0),
                              ClassNLLCriterion(), devices=[cuda_device])
        opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
        opt.set_compute_precision("bfloat16")
        opt.set_gradient_clipping_by_l2_norm(1.0)
        opt.set_checkpoint(str(path), several_iteration(4))
        opt.set_end_when(max_iteration(10))
        if resume:
            assert opt.resume_from_latest_checkpoint()
        losses = []
        opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
        opt.optimize()
        return model, losses

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        full_model, full = run(tmp_path / "a", False)
        shutil.copytree(tmp_path / "a" / "iter4", tmp_path / "b" / "iter4")
        model, rest = run(tmp_path / "b", True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    assert rest == full[4:]
    for a, b in zip(full_model.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)


_DP_RANK = r'''
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from bigdl_tpu_torch.utils.engine import Engine
Engine.init(distributed=True, backend="gloo")
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.ops import bn_relu_kernel as bk
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
from bigdl_tpu_torch.parallel import collectives
rank = collectives.rank()
rs = np.random.RandomState(5)
x = rs.rand(8, 16, 16, 3).astype(np.float32)[4 * rank:4 * rank + 4]
y = (rs.randint(0, 10, 8) + 1).astype(np.int32)[4 * rank:4 * rank + 4]
model = ResNet(10, depth=8, data_set="cifar10", device="cuda",
               generator=torch.Generator().manual_seed(0))
opt = DistriOptimizer(model, LocalDataSet([MiniBatch(
    torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())]),
    ClassNLLCriterion())
opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
opt.set_end_when(max_iteration(3))
losses, first = [], {}
def hook(s):
    losses.append(s["loss"])
    if s["neval"] == 1:
        first.update({k: v.cpu().clone() for k, v in model.state_dict().items()})
opt.set_iteration_hook(hook)
opt.optimize()
out = os.environ["OUT"]
torch.save(first, f"{out}/rank{rank}.pt")
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"losses": losses, "bn": collectives.counts["bn"],
               "launches": [bk.bn_relu_forward.launches,
                            bk.bn_relu_backward.launches],
               "device": str(Engine.device)}, f)
Engine.shutdown()
'''


def test_two_gloo_ranks_on_one_card_match_one_process(cuda_device,
                                                      tmp_path, monkeypatch):
    """Data parallel on the card: two ranks over gloo sharing it, each on
    half of a b8 batch, 3 f32 SGD steps of the CIFAR ResNet-8, against one
    process on the whole batch: losses within a relative 1e-4; after the
    first step, the parameters within 1e-3 of the step's update (norms
    over every parameter; `chip_smoke.py` DP_UPDATE_RTOL: a
    zero-initialised BN scale's gradient, a small difference of large
    sums, moves by up to 1% in another summation order) and each BN
    running stat within 1e-4 of its tensor's largest element (the same
    f32 terms in another order); kernels 6-7 launch on both ranks."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    _build.build_kernels()  # before the ranks start: they only load
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "rank.py").write_text(_DP_RANK)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py")],
        env=dict(os.environ, REPO_ROOT=root, OUT=str(tmp_path),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]

    rs = np.random.RandomState(5)
    x = rs.rand(8, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, 8) + 1).astype(np.int32)
    model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    opt = DistriOptimizer(model, LocalDataSet([MiniBatch(
        torch.from_numpy(x).to(cuda_device),
        torch.from_numpy(y).to(cuda_device))]), ClassNLLCriterion())
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(max_iteration(3))
    init = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    losses, first = [], {}

    def hook(s):
        losses.append(s["loss"])
        if s["neval"] == 1:
            first.update({k: v.cpu().clone()
                          for k, v in model.state_dict().items()})

    opt.set_iteration_hook(hook)
    # as the ranks run: f32 convolutions (no TF32), deterministic
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    opt.optimize()
    for r in ranks:
        assert r["device"] == "cuda:0"
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        assert r["bn"] == 3 * 4 * sum(
            1 for m in model.modules() if hasattr(m, "_axes"))
        assert r["launches"][0] > 0 and r["launches"][0] == r["launches"][1]
    got = torch.load(tmp_path / "rank0.pt")
    names = {k for k, _ in model.named_parameters()}
    dist = sum(float((got[k] - first[k]).pow(2).sum()) for k in names)
    update = sum(float((first[k] - init[k]).pow(2).sum()) for k in names)
    assert dist ** 0.5 <= 1e-3 * update ** 0.5
    for k, want in first.items():
        if k not in names and want.is_floating_point():
            tol = 1e-4 * max(float(want.abs().max()), 1e-6)
            assert float((got[k] - want).abs().max()) <= tol, k


# ------------------------------------------------ the Wide&Deep sparse stack

def _sparse_pair(make, cuda_device):
    cpu = make("cpu")
    card = make("cpu")
    card.load_state_dict(cpu.state_dict())
    return cpu, card.to(cuda_device)


def _run_sparse(layer, inputs):
    from bigdl_tpu_torch.utils import T
    out = layer(T(*inputs) if isinstance(inputs, list) else inputs)
    (out * out).sum().backward()
    return out.detach().cpu(), {n: p.grad.cpu()
                                for n, p in layer.named_parameters()}


def _assert_close_f32(got, want, what):
    tol = 1e-5 * max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol, what


def test_sparse_layers_on_cuda_match_cpu(cuda_device):
    """`LookupTableSparse` (each combiner, a finite max_norm, 0 padding)
    and `SparseLinear` (-1 padding, an index past the last row, float and
    int64 indices on the card): outputs and gradients within 1e-5 of
    their CPU run's largest element (f32; the embedding backward's
    atomics add in another order)."""
    from bigdl_tpu_torch import nn as tnn
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 11, (64, 7)).astype(np.int64)
    wts = rs.rand(64, 7).astype(np.float32)
    for combiner in ("sum", "mean", "sqrtn"):
        cpu, card = _sparse_pair(lambda d: tnn.LookupTableSparse(
            10, 6, combiner, 1.5, device=d,
            generator=torch.Generator().manual_seed(1)), cuda_device)
        want = _run_sparse(cpu, [torch.from_numpy(ids),
                                 torch.from_numpy(wts)])
        got = _run_sparse(card, [torch.from_numpy(ids).to(cuda_device),
                                 torch.from_numpy(wts).to(cuda_device)])
        _assert_close_f32(got[0], want[0], combiner)
        for n in want[1]:
            _assert_close_f32(got[1][n], want[1][n], f"{combiner} {n}")
    idx = rs.randint(-1, 120, (1024, 3))
    vals = rs.rand(1024, 3).astype(np.float32)
    for dtype in (torch.int64, torch.float32):
        cpu, card = _sparse_pair(lambda d: tnn.SparseLinear(
            100, 2, device=d, generator=torch.Generator().manual_seed(2)),
            cuda_device)
        i = torch.from_numpy(idx).to(dtype)
        want = _run_sparse(cpu, [i, torch.from_numpy(vals)])
        got = _run_sparse(card, [i.to(cuda_device),
                                 torch.from_numpy(vals).to(cuda_device)])
        _assert_close_f32(got[0], want[0], f"SparseLinear {dtype}")
        for n in want[1]:
            _assert_close_f32(got[1][n], want[1][n], f"SparseLinear {n}")


def test_feature_columns_take_the_card_s_index_tensors(cuda_device):
    from bigdl_tpu_torch.ops import IndicatorCol
    ids = torch.tensor([[0, 1, 1], [4, -1, 2], [7, 3, 3]])
    for is_count in (True, False):
        want = IndicatorCol(5, is_count, device="cpu")(ids)
        got = IndicatorCol(5, is_count, device=cuda_device)(
            ids.to(cuda_device))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# ------------------------------------------- pipeline, experts, predictor


def test_1f1b_on_the_card_matches_its_microbatch_oracle(cuda_device):
    """CIFAR ResNet-8 split into 3 stages over a "pipe" mesh that repeats
    the card, 4 microbatches: the 1F1B loss and gradients against the
    microbatch oracle (f32, TF32 off: the same kernels in the same order,
    within 1e-5 relative), kernel 6 at 4 sites x 4 microbatches x 2 (the F
    tick and the B tick's recompute) and kernel 7 at 4 x 4 a step, and
    every BN buffer unchanged."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.parallel import Mesh, PipelineStages, split_sequential
    from bigdl_tpu_torch.tools.pipeline_resnet import microbatch_oracle
    torch.backends.cudnn.allow_tf32 = False
    model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
    stages = split_sequential(model, 3)
    pipe = PipelineStages(stages, 4, torch.zeros(4, 32, 32, 3,
                                                 device=cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(16, 32, 32, 3, generator=g, device=cuda_device)
    y = torch.randint(1, 11, (16,), generator=g, device=cuda_device)
    buffers = [b.clone() for b in model.buffers()]
    mesh = Mesh([cuda_device] * 3, ("pipe",))
    crit = ClassNLLCriterion()
    f0, b0 = tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches
    loss, grads = pipe.train_step_1f1b(mesh, x, y, crit)
    torch.cuda.synchronize()
    assert tbk.bn_relu_forward.launches - f0 == 4 * 4 * 2
    assert tbk.bn_relu_backward.launches - b0 == 4 * 4
    oloss, ograds = microbatch_oracle(pipe, x, y, crit)
    torch.testing.assert_close(loss, oloss, rtol=1e-5, atol=0)
    for got, want in zip(grads, ograds):
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                       atol=1e-6 * float(
                                           want[name].abs().max()))
    for b, saved in zip(model.buffers(), buffers):
        assert torch.equal(b, saved)


@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_on_the_card_matches_dense_capacity(cuda_device,
                                                            top_k):
    """4 expert positions on the card, a skewed router at capacity factor
    1.25: the drop masks equal, outputs within 1e-5 relative (f32, TF32
    off; the same expert products over other row sets)."""
    from bigdl_tpu_torch.parallel import Mesh, MoE
    moe = MoE(64, 128, 8, 1.25, top_k, device=cuda_device,
              generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        moe.router.add_(torch.randn(64, 8, generator=torch.Generator()
                                    .manual_seed(4)).to(cuda_device) * 0.5)
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(5)
                    ).to(cuda_device)
    with torch.no_grad():
        y, mask = moe.expert_parallel_apply(
            Mesh([cuda_device] * 4, ("expert",)), x, return_mask=True)
        want, want_mask = moe.dense_capacity_apply(x, 4, return_mask=True)
    assert torch.equal(mask, want_mask) and int((~mask).sum()) > 0
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_distri_predictor_on_the_card_matches_local(cuda_device):
    """A CIFAR ResNet-8 served over a "data" mesh that repeats the card:
    rows equal `LocalPredictor`'s within 1e-5 relative of the row's
    largest element, the same classes, one forward (kernel 6 once a fused
    site) per batch, the ragged last batch padded."""
    from bigdl_tpu_torch.optim import DistriPredictor, LocalPredictor
    from bigdl_tpu_torch.parallel import Mesh
    torch.backends.cudnn.allow_tf32 = False
    model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
    x = np.random.RandomState(0).rand(21, 32, 32, 3).astype(np.float32)
    local = LocalPredictor(model, 8, convert=False)
    want = local.predict(x)
    pred = DistriPredictor(model, 8, Mesh([cuda_device] * 2, ("data",)),
                           convert=False)
    f0 = tbk.bn_relu_forward.launches
    got = pred.predict(x)
    assert tbk.bn_relu_forward.launches - f0 == 4 * 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(),
                                   rtol=0)
    assert pred.predict_class(x) == local.predict_class(x)


def test_prefetched_pinned_batches_train_as_serial_on_the_card(cuda_device):
    """The operations stack on the card: a CIFAR ResNet-8 fed by a
    transformer chain through `set_prefetch(workers=3)` (pinned batches,
    `non_blocking` copies) trains to the serial run's losses bit for bit
    within an epoch, the batches arrive pinned, and the one `compile`
    record names the card and carries the step records' FLOPs."""
    from bigdl_tpu_torch.dataset import (FuncTransformer, LocalDataSet,
                                         Sample, SampleToMiniBatch)
    from bigdl_tpu_torch.dataset.prefetch import build_input_pipeline
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer,
                                       max_iteration)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rs = np.random.RandomState(0)
    samples = [Sample(rs.rand(32, 32, 3).astype(np.float32),
                      np.int32(rs.randint(0, 10) + 1)) for _ in range(48)]

    def ds():
        # 6 steps of 8 are one epoch of 48 samples: the epoch's shuffle,
        # whose place among a prefetch's pulls is timing's, comes last
        return LocalDataSet(samples).transform(
            FuncTransformer(lambda s: Sample(s.feature * 2.0, s.label))
            >> SampleToMiniBatch(8))

    pipe = build_input_pipeline(ds(), workers=2, depth=4, pin_memory=True)
    assert next(pipe).get_input().is_pinned()
    pipe.close()

    def run(prefetch):
        torch.manual_seed(0)
        model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
        opt = DistriOptimizer(model, ds(), ClassNLLCriterion(),
                              devices=[cuda_device])
        opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
        opt.set_end_when(max_iteration(6))
        sink = InMemorySink()
        opt.set_telemetry(Telemetry(sink, resources=False, flight=False))
        if prefetch:
            opt.set_prefetch(workers=3)
        losses = []
        opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
        opt.optimize()
        return losses, sink.records

    try:
        serial, _ = run(False)
        pre, recs = run(True)
    finally:
        torch.backends.cudnn.deterministic = False
    assert pre == serial
    (rec,) = [r for r in recs if r["type"] == "compile"]
    steps = [r for r in recs if r["type"] == "step"]
    assert rec["signature"].endswith("@cuda:0")
    assert rec["flops"] == steps[0]["flops_per_step"] > 0
    assert all("prefetch_queue_depth" in r for r in steps)


def test_model_file_crosses_between_the_card_and_the_cpu(cuda_device,
                                                          tmp_path):
    """A model file written on the card loads on the CPU, and one written
    on the CPU loads on the card: every parameter and BN buffer bit for
    bit, on the device asked for, and the same forward (f32, TF32 off:
    within 1e-5 of the largest output element)."""
    from bigdl_tpu_torch.models import VggForCifar10
    from bigdl_tpu_torch.serialization import ModuleSerializer
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 32, 32, 3, generator=g)
    for src, dst in ((cuda_device, torch.device("cpu")),
                     (torch.device("cpu"), cuda_device)):
        model = VggForCifar10(10, device=src).eval()
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith(("mean", "var")):
                    buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        path = str(tmp_path / f"{src.type}.bigdl")
        ModuleSerializer.save(model, path)
        loaded = ModuleSerializer.load(path, device=dst)
        want, got = model.state_dict(), loaded.state_dict()
        assert set(want) == set(got)
        for k in want:
            assert got[k].device.type == dst.type, k
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
        with torch.no_grad():
            a = model(x.to(src)).cpu()
            b = loaded.eval()(x.to(dst)).cpu()
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-5 * a.abs().max().item())


def test_fleet_replay_is_invariant_on_the_card(cuda_device):
    """A workload with a kill and a restore replayed twice at one seed
    over fresh fleets of 2 `InferenceEngine`s serving a CIFAR ResNet-8 on
    the card: the canonical streams identical under `compare_streams`,
    every request ok, both chaos actions fired."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.serving import ServingFleet
    from bigdl_tpu_torch.workload import (ChaosAction, ChaosSchedule,
                                          VirtualClock, WorkloadReplayer,
                                          compare_streams, poisson_arrivals,
                                          synthesize)
    model = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
    arrivals = poisson_arrivals(40.0, 1.0, seed=3)
    n = len(arrivals)
    wl = synthesize("card", arrivals, seed=3, shape=[32, 32, 3],
                    deadline_ms=60_000.0, sessions=3,
                    chaos=[ChaosAction("kill", after_entries=n // 3)
                           .to_dict(),
                           ChaosAction("restore", after_entries=2 * n // 3)
                           .to_dict()])

    def replay():
        sink = InMemorySink()
        tel = Telemetry(sink, resources=False, flight=False)
        fleet = ServingFleet(
            model, n_replicas=2,
            warmup_sample=Sample(np.zeros((32, 32, 3), np.float32)),
            drain_grace_s=0.5, seed=0,
            engine_kwargs={"max_batch_size": 8, "max_wait_ms": 1.0,
                           "device": cuda_device})
        try:
            summary = WorkloadReplayer(
                fleet, wl, chaos=ChaosSchedule.from_dicts(wl.chaos, seed=3),
                seed=3, clock=VirtualClock(), telemetry=tel,
                progress_every=10).run()
        finally:
            fleet.close()
            tel.close()
        return sink.records, summary

    a, summary = replay()
    b, _ = replay()
    assert not compare_streams(a, b).divergent
    assert summary["ok"] == n and summary["chaos_fired"] == 2


def _graph_of(seq):
    """A port ResNet `Sequential` as an `nn.Graph` over a deep copy of its
    leaves (a `ConcatTable` a fan-out, the node after it taking both
    branches)."""
    import copy

    from bigdl_tpu_torch.nn import ConcatTable, Graph, InputNode, Sequential

    def chain(m, node):
        if isinstance(m, Sequential):
            for c in m.children_in_order():
                node = chain(c, node)
            return node
        if isinstance(m, ConcatTable):
            return [chain(c, node) for c in m.children_in_order()]
        return m.inputs(node)

    inp = InputNode()
    return Graph([inp], [chain(copy.deepcopy(seq), inp)])


def test_graph_fused_sites_launch_kernels_6_7_as_its_sequential(
        cuda_device):
    """A CIFAR ResNet-8 and its Graph, one forward and backward each
    (f32, deterministic cuDNN): kernels 6 and 7 launch at the
    Sequential's count (4 fused sites) and the outputs and input
    gradients are the same bits."""
    torch.backends.cudnn.deterministic = True
    try:
        seq = ResNet(10, depth=8, data_set="cifar10", device=cuda_device)
        graph = _graph_of(seq)
        assert len(graph._fusion_plan()[0]) == 4
        x = torch.rand(4, 32, 32, 3, generator=torch.Generator()
                       .manual_seed(0)).to(cuda_device)
        runs = []
        for model in (seq, graph):
            tbk.bn_relu_forward.launches = tbk.bn_relu_backward.launches = 0
            xi = x.clone().requires_grad_()
            out = model.train()(xi)
            out.sum().backward()
            runs.append((out.detach(), xi.grad, tbk.bn_relu_forward.launches,
                         tbk.bn_relu_backward.launches))
        (o1, g1, f1, b1), (o2, g2, f2, b2) = runs
        assert (f1, b1) == (f2, b2) == (4, 4)
        assert torch.equal(o1, o2) and torch.equal(g1, g2)
    finally:
        torch.backends.cudnn.deterministic = False


def test_set_graph_optimizations_launches_kernel_5_in_a_graph(cuda_device,
                                                              monkeypatch):
    """A Graph with a 7x7/s2 stem trained 2 steps through `LocalOptimizer`
    with the stem switch set: with `set_graph_optimizations(True)` the
    stem is restated in the graph and kernel 5 launches once a step;
    without it, never."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    monkeypatch.setenv("BIGDL_TPU_PALLAS_STEM", "1")
    rs = np.random.RandomState(0)
    x = rs.rand(8, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 4, size=8) + 1).astype(np.int32)
    for optimize in (True, False):
        inp = nn.InputNode()
        h = nn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  device=cuda_device).inputs(inp)
        h = nn.ReLU().inputs(nn.SpatialBatchNormalization(
            16, device=cuda_device).inputs(h))
        out = nn.LogSoftMax().inputs(nn.Linear(
            16, 4, device=cuda_device).inputs(nn.Pooler().inputs(h)))
        graph = nn.Graph([inp], [out])
        opt = LocalOptimizer(graph, LocalDataSet([MiniBatch(x, y)]),
                             nn.ClassNLLCriterion(), device=cuda_device)
        opt.set_graph_optimizations(optimize)
        opt.set_optim_method(SGD(learning_rate=0.01))
        opt.set_end_when(max_iteration(2))
        tsk.stem_conv_forward.launches = 0
        tbk.bn_relu_forward.launches = 0
        opt.optimize()
        stem = graph.exec_order[1].module
        assert type(stem).__name__ == ("SpaceToDepthStemConvolution"
                                       if optimize else "SpatialConvolution")
        assert tsk.stem_conv_forward.launches == (2 if optimize else 0)
        assert tbk.bn_relu_forward.launches == 2


def test_remat_resnet_matches_its_twin_on_the_card(cuda_device):
    """ResNet-18 (10 classes, 64x64, b4, f32, deterministic cuDNN) with
    `remat=True` against its `remat=False` twin from the same weights, one
    training forward and backward each: the outputs, every gradient and
    every BN buffer the same bits; kernel 6 launches 9 + 8 times with
    remat (its 8 in-block sites run again in the recompute), 9 without,
    and kernel 7 9 times in both."""
    torch.backends.cudnn.deterministic = True
    try:
        x = torch.rand(4, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(0)).to(cuda_device)
        runs = []
        for remat in (True, False):
            model = ResNet(10, depth=18, remat=remat, device=cuda_device,
                           generator=torch.Generator().manual_seed(0))
            tbk.bn_relu_forward.launches = tbk.bn_relu_backward.launches = 0
            out = model.train()(x)
            (out * torch.arange(10, device=cuda_device)).sum().backward()
            state = {}
            for k, v in model.state_dict().items():
                head, _, rest = k.partition(".")
                if head.endswith("_Remat"):
                    k = head[:-5] + "Sequential." + rest.partition(".")[2]
                state[k] = v
            grads = [p.grad for p in model.parameters()]
            runs.append((out.detach(), grads, state,
                         tbk.bn_relu_forward.launches,
                         tbk.bn_relu_backward.launches))
        (o1, g1, s1, f1, b1), (o2, g2, s2, f2, b2) = runs
        assert (f1, b1, f2, b2) == (17, 9, 9, 9)
        assert torch.equal(o1, o2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
        assert s1.keys() == s2.keys()
        assert all(torch.equal(s1[k], s2[k]) for k in s2)
    finally:
        torch.backends.cudnn.deterministic = False


def test_gru_on_the_card_matches_the_cpu(cuda_device):
    """`Recurrent(GRUCell(64, 128))` over b8 T12 on the card against the
    same weights on the CPU, f32, TF32 off: the output and every gradient
    within 1e-5 of its tensor's largest element (cuBLAS and oneDNN sum in
    other orders)."""
    import copy

    from bigdl_tpu_torch import nn
    cpu = nn.Recurrent(nn.GRUCell(64, 128, device="cpu",
                                  generator=torch.Generator().manual_seed(1)))
    card = copy.deepcopy(cpu).to(cuda_device)
    x = torch.randn(8, 12, 64, generator=torch.Generator().manual_seed(2))
    w = torch.randn(8, 12, 128, generator=torch.Generator().manual_seed(3))
    runs = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        xi = x.to(dev, copy=True).requires_grad_()
        out = model(xi)
        (out * w.to(dev)).sum().backward()
        runs.append([out.detach().cpu(), xi.grad.cpu()]
                    + [p.grad.cpu() for p in model.parameters()])
    for want, got in zip(*runs):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
