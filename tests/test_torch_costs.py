"""Port parity: `bigdl_tpu_torch.observability.costs` against
`bigdl_tpu.observability.costs`.

- `peak_flops` for the reference's TPU kinds (the same figures), the two
  H100s, and None for the CPU; `mfu` against the reference's on the same
  inputs (exact: the same float operations);
- `count_flops` of one training step of a small ResNet (the CIFAR
  ResNet-8 at b4, 16x16) and a 2-layer LM (b2, T=16), counted on the step
  the optimizer runs (`tools.bench.step_flops`), against an analytic count
  of their convolutions and matmuls (forward and backward) plus each
  kernel's formula, within 0.1% (they agree exactly);
- the same steps against the reference's XLA cost-model count of its own
  step (`bench_cli._step_flops`'s route), at the ratio stated beside each
  case, within 1% (the counts depend on shapes only, so the ratio is
  fixed);
- the count is the same whatever runs the kernels: their plain versions
  on the CPU (hidden from the counter), the plain versions run out of
  the counter's sight altogether (as a `ctypes` launch is on the card),
  and the meta device, where the wrappers only count (`step_flops`).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.observability import costs as jcosts
from bigdl_tpu.tools.bench_cli import _step_flops
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params,
                                     load_transformer_lm_params)
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn.fusion import fusible_activation, fusible_bn
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.ops import attention_kernel as ak
from bigdl_tpu_torch.ops import bn_relu_kernel as bk
from bigdl_tpu_torch.tools.bench import step_flops

TPU_KINDS = ["TPU v2", "TPU v3", "TPU v4", "TPU v5 lite", "TPU v5e",
             "TPU v5p", "TPU v5", "TPU v6 lite", "Trillium", "cpu", "",
             "NVIDIA A100-SXM4-80GB"]


@pytest.mark.parametrize("kind", TPU_KINDS)
def test_peak_flops_matches_the_reference(kind):
    assert costs.peak_flops(kind) == jcosts.peak_flops(kind)


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 989e12), ("cpu", None)])
def test_peak_flops_of_the_cards(kind, peak):
    assert costs.peak_flops(kind) == peak


def test_peak_flops_takes_a_torch_device():
    assert costs.peak_flops(torch.device("cpu")) is None


@pytest.mark.parametrize("flops,t,kind,n", [
    (197e12, 2.0, "TPU v5e", 1), (1e12, 0.5, "TPU v4", 4),
    (3.3e15, 1.7, "TPU v6 lite", 8), (1e12, 1.0, "cpu", 1),
    (None, 1.0, "TPU v4", 1), (1e12, None, "TPU v4", 1),
    (float("nan"), 1.0, "TPU v4", 1), (1e12, 0.0, "TPU v4", 1),
    (-1.0, 1.0, "TPU v4", 1), (1e12, float("inf"), "TPU v4", 1),
    (1e12, 1.0, "TPU v4", 0)])
def test_mfu_matches_the_reference(flops, t, kind, n):
    assert costs.mfu(flops, t, kind, n) == jcosts.mfu(flops, t, kind, n)


def test_mfu_on_an_h100():
    assert costs.mfu(989e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5


# --------------------------------------------------------------------------
# Counting a training step
# --------------------------------------------------------------------------

B, HW = 4, 16


def _resnet_pair():
    jm = JResNet(10, depth=8, data_set="cifar10")
    params = jm.ensure_params()
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    load_module_params(tm, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, jm._state))
    return jm, params, tm


def _resnet_opt(tm):
    rs = np.random.RandomState(0)
    x = rs.rand(B, HW, HW, 3).astype(np.float32)
    y = (rs.randint(0, 10, B) + 1).astype(np.int32)
    opt = toptim.DistriOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), devices=["cpu"])
    return opt.set_optim_method(toptim.SGD(0.01, momentum=0.9))


def _resnet_analytic(tm):
    """Convolutions and the linear layer forward and backward (the input
    gradient of every layer but the first convolution, whose input needs
    none), plus 3 + 7 operations an element at each fused BN+ReLU site."""
    convs, outs = [], {}

    def hook(mod, inp, out):
        outs[mod] = out.numel()
        convs.append((mod, inp[0], out))

    handles = [m.register_forward_hook(hook) for m in tm.modules()
               if isinstance(m, (tnn.SpatialConvolution, tnn.Linear))]
    with torch.no_grad():
        tm(torch.zeros(B, HW, HW, 3))
    for h in handles:
        h.remove()
    total = 0
    for i, (mod, x, out) in enumerate(convs):
        if isinstance(mod, tnn.SpatialConvolution):
            o, c, kh, kw = mod.weight.shape
            fwd = 2 * out.numel() * c * kh * kw
        else:
            fwd = 2 * x.shape[0] * mod.weight.shape[0] * mod.weight.shape[1]
        total += fwd * (2 if i == 0 else 3)
    sites = 0
    for seq in tm.modules():
        if isinstance(seq, tnn.Sequential):
            kids = seq.children_in_order()
            for a, b_, c in zip(kids, kids[1:], kids[2:]):
                if a in outs and fusible_bn(b_) and fusible_activation(c):
                    total += 10 * outs[a]
                    sites += 1
    assert sites == 4  # the stem and the first BN of each basic block
    return total


def test_resnet_step_count_is_analytic():
    _, _, tm = _resnet_pair()
    assert step_flops(_resnet_opt(tm)) == pytest.approx(
        _resnet_analytic(tm), rel=1e-3)


#: port / XLA for the ResNet-8 step at b4, 16x16. The gap, term by term:
#: XLA skips the convolution taps that read zero padding (a 3x3 SAME
#: convolution over 4x4 counts 100 of its 144 taps), which takes it below
#: the port; it counts the input gradient of a stride-2 convolution over
#: the dilated cotangent, and one FLOP an element for every elementwise
#: op (BN, ReLU, the loss, the SGD update), which take it above; the port
#: counts the BN+ReLU kernels' 3 + 7 operations an element at 4 sites.
RESNET_RATIO = 1.1262


def test_resnet_step_count_against_xla():
    jm, params, tm = _resnet_pair()
    xla = _step_flops(jm, jnn.ClassNLLCriterion(),
                      joptim.SGD(0.01, momentum=0.9), params, jm._state, B,
                      (HW, HW, 3))
    assert step_flops(_resnet_opt(tm)) / xla == pytest.approx(
        RESNET_RATIO, rel=1e-2)


VOCAB, EMBED, LAYERS, HEADS, T, LB = 64, 32, 2, 4, 16, 2


def _lm_pair():
    jm = JaxLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS, n_head=HEADS)
    params = jm.ensure_params(jax.random.PRNGKey(0))
    tm = TransformerLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS, n_head=HEADS,
                       device="cpu")
    load_transformer_lm_params(tm, jax.tree_util.tree_map(np.asarray,
                                                          params))
    rs = np.random.RandomState(1)
    toks = rs.randint(1, VOCAB + 1, (LB, T + 1)).astype(np.int32)
    return jm, params, tm, toks[:, :-1], toks[:, 1:]


def _lm_opt(tm, x, y):
    opt = toptim.DistriOptimizer(
        tm, LocalDataSet([MiniBatch(x, y)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()),
        devices=["cpu"])
    return opt.set_optim_method(toptim.SGD(0.01, momentum=0.9))


def _lm_analytic():
    """Every matmul three times (forward, input and weight gradients):
    per layer q, k, v, o (E x E) and the MLP (E x 4E, 4E x E), then the
    head (E x V); plus kernels 1, 3 and 4 per layer: 2 + 3 + 4 products
    of 2*D a product for each unmasked (query, key) pair of each head."""
    rows = LB * T
    per_layer = 4 * 2 * rows * EMBED * EMBED + 2 * 2 * rows * EMBED * 4 * \
        EMBED
    matmuls = 3 * (LAYERS * per_layer + 2 * rows * EMBED * VOCAB)
    pairs = T * (T + 1) // 2
    kernels = LAYERS * 9 * 2 * (EMBED // HEADS) * LB * HEADS * pairs
    return matmuls + kernels


def test_lm_step_count_is_analytic():
    _, _, tm, x, y = _lm_pair()
    assert step_flops(_lm_opt(tm, x, y)) == pytest.approx(_lm_analytic(),
                                                          rel=1e-3)


#: port / XLA for the 2-layer LM step at b2, T=16. The gap: the
#: reference's blockwise attention on the CPU computes (and XLA counts)
#: every (query, key) pair, masked ones included (256 against 136 a head
#: here), with 2 products forward and 4 backward; the port's kernels count
#: the unmasked pairs with 2 + 3 + 4 products (dq and dk/dv each recompute
#: S); XLA also counts one FLOP an element for every elementwise op
#: (softmax, GELU, LayerNorm, RoPE, the loss, the SGD update).
LM_RATIO = 0.7980


def test_lm_step_count_against_xla():
    jm, params, tm, x, y = _lm_pair()
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    method = joptim.SGD(0.01, momentum=0.9)

    def step(p, o, x, y):
        def loss_fn(p):
            out, _ = functional_apply(jm, p, x, training=True)
            return crit(out, y)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        new_p, new_o = method.update(grads, o, p, 0.01)
        return new_p, new_o, loss

    cost = jax.jit(step).lower(params, method.init_state(params),
                               jnp.asarray(x), jnp.asarray(y)).compile() \
        .cost_analysis()
    xla = (cost[0] if isinstance(cost, list) else cost)["flops"]
    assert step_flops(_lm_opt(tm, x, y)) / xla == pytest.approx(
        LM_RATIO, rel=1e-2)


def _out_of_sight(fn):
    """`fn` run where no dispatch mode sees it, as a ctypes launch is."""
    from torch.utils._python_dispatch import _disable_current_modes

    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


PLAIN = [(ak, name) for name in (
    "flash_attention_forward_plain", "flash_attention_carry_plain",
    "flash_attention_backward_dq_plain",
    "flash_attention_backward_dkv_plain")] + \
    [(bk, "bn_relu_forward_plain"), (bk, "bn_relu_backward_plain")]


def _cpu_step_count(opt):
    """`costs.count_flops` of one real step on the CPU (a copy of the
    model): the kernel wrappers run their plain versions."""
    twin = copy.copy(opt)
    twin.model = copy.deepcopy(opt.model)
    twin.optim_method = copy.deepcopy(opt.optim_method)
    opt_state = twin.optim_method.init_state_with_masters(
        dict(twin.model.named_parameters()))
    batch = next(iter(opt.dataset.data(train=False)))
    x, y = (torch.from_numpy(v) for v in (batch.get_input(),
                                          batch.get_target()))
    return costs.count_flops(twin._build_step(), opt_state, x, y, 0.01)


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_count_is_the_same_whatever_runs_the_kernels(model, monkeypatch):
    """The plain versions' own matmuls (the masked half of causal
    attention among them) are hidden from the count, so hiding them from
    the counter altogether, as the card's launches are, changes nothing;
    nor does counting on shapes alone."""
    if model == "resnet":
        _, _, tm = _resnet_pair()
        opt = _resnet_opt(tm)
    else:
        _, _, tm, x, y = _lm_pair()
        opt = _lm_opt(tm, x, y)
    seen = _cpu_step_count(opt)
    assert step_flops(opt) == seen
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, _out_of_sight(getattr(mod, name)))
    assert _cpu_step_count(opt) == seen


def test_plain_versions_alone_would_count_otherwise():
    """What the count hides: a bare FlopCounterMode sees the plain causal
    forward's full score matrix, every (query, key) pair, where the
    kernel's formula counts the unmasked ones."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = (torch.randn(1, 2, 64, 8) for _ in range(3))
    with FlopCounterMode(display=False) as raw:
        ak.flash_attention_forward(q, k, v, causal=True)
    formula = ak.attention_flops("flash_attention_fwd", q, 64, True)
    assert formula == 2 * 2 * 2 * 8 * (64 * 65 // 2)
    assert costs.count_flops(ak.flash_attention_forward, q, k, v,
                             True) == formula
    assert raw.get_total_flops() == 2 * 2 * 2 * 8 * 64 * 64 > formula


@pytest.mark.parametrize("tq,tk,q_off,k_off", [
    (7, 7, 0, 0), (5, 9, 0, 0), (9, 5, 0, 0), (6, 6, 12, 0), (6, 6, 0, 12),
    (8, 4, 3, 5)])
def test_unmasked_pairs_counts_the_mask(tq, tk, q_off, k_off):
    want = sum(1 for i in range(tq) for j in range(tk)
               if j + k_off <= i + q_off)
    assert ak.unmasked_pairs(tq, tk, True, q_off, k_off) == want
    assert ak.unmasked_pairs(tq, tk, False, q_off, k_off) == tq * tk


def test_stem_formula_counts_the_restated_convolution():
    from bigdl_tpu_torch.ops import stem_kernel as sk
    x2, wk = torch.zeros(2, 5, 6, 12), torch.zeros(4, 4, 12, 8)
    assert sk.stem_flops(x2, wk) == 2 * 7 * 7 * 3 * 2 * 5 * 6 * 8
    assert costs.count_flops(sk.stem_conv_forward, x2, wk, None, 2, 1) == \
        sk.stem_flops(x2, wk)


def test_count_flops_is_off_outside_a_count():
    assert costs._SESSIONS == []
    costs.tally_kernel(lambda: 1 / 0)  # never evaluated without a count


def test_a_count_sees_only_its_own_thread():
    """A serving engine counts a bucket on the meta device while other
    replicas launch kernels: their tallies must stay out of its count."""
    import threading
    inside, done, result = threading.Event(), threading.Event(), []

    def count():
        def fn():
            inside.set()
            done.wait(10)
            costs.tally_kernel(lambda: 7)
        result.append(costs.count_flops(fn))

    t = threading.Thread(target=count)
    t.start()
    assert inside.wait(10)
    assert not costs.counting()  # the other thread's count is not ours
    costs.tally_kernel(lambda: 1 / 0)  # never evaluated here
    done.set()
    t.join()
    assert result == [7]
