"""Port parity: the space-to-depth stem (kernel 5) of `bigdl_tpu_torch`
against `bigdl_tpu`.

- The plain version of the stem kernel (`stem_conv_forward_plain`, what
  `stem_conv_forward` runs on a CPU tensor) against the JAX Pallas kernel
  `stem_conv_forward(..., interpret=True)`, for k = 3, 7, 11 (kt = 2, 4,
  6), C_in = 1 and 3, with and without the bias, on even and ragged x2, in
  f32: within 1e-5 * max|ref| (the same f32 products summed in another
  order by two different matmuls).
- `SpaceToDepthStemConvolution` with `pallas_stem` True, False and None
  (with `BIGDL_TPU_PALLAS_STEM` set) against the JAX layer with
  `bigdl_tpu.ops.stem_kernel.INTERPRET` monkeypatched on (its Pallas stem
  in interpret mode), outputs and gradients (x, weight, bias) of
  sum(out * w) within 1e-5 * max|ref|; the odd-size fallback likewise.
- `StemConvFunction`'s backward (the plain convolution's gradients with
  the asymmetric padding made explicit) against autograd through the plain
  version, within 1e-5 * max|ref|.
- The wrapper's refusals, and its launch count (CPU tensors run the plain
  version and launch nothing).
- `tools/ab_stem.py` and `tools/bench.py --model serve` at a tiny size on
  the CPU (routes, seeds and the switch's restoration; no times).

The card-only checks (the CUDA kernel against its plain version) are in
`tests/test_torch_cuda.py`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.ops import stem_kernel as jsk
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.ops import stem_kernel as tsk

RTOL = 1e-5  # of max|ref|: f32 sums in another order


def _pads(k):
    kt = (k + 1) // 2
    front = ((k - 1) // 2 + 1) // 2
    return kt, front, kt - 1 - front


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("h2,w2", [(6, 8), (5, 7)])  # even, ragged
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin", [1, 3])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_plain_matches_pallas_interpret(k, cin, with_bias, h2, w2):
    kt, front, rear = _pads(k)
    rs = np.random.RandomState(k * 10 + cin)
    x2 = rs.randn(2, h2, w2, 4 * cin).astype(np.float32)
    wk = rs.randn(kt, kt, 4 * cin, 8).astype(np.float32)
    bias = rs.randn(8).astype(np.float32) if with_bias else None
    want = jsk.stem_conv_forward(
        jnp.asarray(x2), jnp.asarray(wk),
        None if bias is None else jnp.asarray(bias), front, rear,
        interpret=True)
    before = tsk.stem_conv_forward.launches
    got = tsk.stem_conv_forward(
        torch.from_numpy(x2), torch.from_numpy(wk),
        None if bias is None else torch.from_numpy(bias), front, rear)
    assert tsk.stem_conv_forward.launches == before  # CPU: no kernel
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_plain_keeps_bf16_dtype_and_rounds_once():
    rs = np.random.RandomState(1)
    x2 = torch.from_numpy(rs.randn(1, 4, 6, 12).astype(np.float32))
    wk = torch.from_numpy(rs.randn(4, 4, 12, 8).astype(np.float32))
    got = tsk.stem_conv_forward(x2.bfloat16(), wk.bfloat16(), None, 2, 1)
    assert got.dtype == torch.bfloat16
    want = tsk.stem_conv_forward_plain(x2.bfloat16().float(),
                                       wk.bfloat16().float(), None, 2, 1)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def _layer_value_and_grads(jmod, tmod, params, x, w):
    """(out, d/dparams, d/dx) of sum(out * w): JAX, then the port."""
    def f(p, xx):
        out, _ = functional_apply(jmod, p, xx, training=True)
        return jnp.sum(out * w), out
    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt)
    (out_t * torch.from_numpy(w)).sum().backward()
    return ((np.asarray(out_j), jax.tree_util.tree_map(np.asarray, gp_j),
             np.asarray(gx_j)),
            (out_t.detach().numpy(), module_params_tree(tmod, grad=True),
             xt.grad.numpy()))


@pytest.mark.parametrize("hw", [16, 15])  # the s2d route, the odd fallback
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("route", ["true", "false", "env"])
def test_layer_matches_jax_pallas_stem(monkeypatch, route, with_bias, hw):
    monkeypatch.setattr(jsk, "INTERPRET", True)
    calls = {"n": 0}
    plain = tsk.stem_conv_forward_plain

    def counted(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(tsk, "stem_conv_forward_plain", counted)
    pallas = {"true": True, "false": False, "env": None}[route]
    if route == "env":
        monkeypatch.setenv("BIGDL_TPU_PALLAS_STEM", "1")
    else:
        monkeypatch.delenv("BIGDL_TPU_PALLAS_STEM", raising=False)
    jmod = jnn.SpaceToDepthStemConvolution(3, 8, 7, with_bias=with_bias)
    tmod = tnn.SpaceToDepthStemConvolution(3, 8, 7, with_bias=with_bias,
                                           pallas_stem=pallas, device="cpu")
    params = jax.tree_util.tree_map(np.asarray,
                                    jmod.init(jax.random.PRNGKey(2)))
    if with_bias:
        params["bias"] = np.random.RandomState(3).randn(8).astype(
            np.float32)
    load_module_params(tmod, params)
    rs = np.random.RandomState(hw)
    x = rs.rand(2, hw, hw, 3).astype(np.float32)
    w = rs.randn(2, (hw + 1) // 2, (hw + 1) // 2, 8).astype(np.float32)
    (out_j, gp_j, gx_j), (out_t, gp_t, gx_t) = _layer_value_and_grads(
        jmod, tmod, params, x, w)
    _close(out_t, out_j, what="out")
    _close(gx_t, gx_j, what="dx")
    assert set(gp_t) == set(gp_j)
    for key in gp_j:
        _close(gp_t[key], gp_j[key], what=key)
    kernel_route = route != "false" and hw % 2 == 0
    assert calls["n"] == int(kernel_route)
    assert tmod.uses_stem_kernel() == (route != "false")


def test_env_switch_is_read_at_each_forward(monkeypatch):
    calls = {"n": 0}
    plain = tsk.stem_conv_forward_plain

    def counted(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(tsk, "stem_conv_forward_plain", counted)
    m = tnn.SpaceToDepthStemConvolution(3, 8, 7, device="cpu")
    x = torch.rand(1, 8, 8, 3)
    monkeypatch.delenv("BIGDL_TPU_PALLAS_STEM", raising=False)
    off = m(x)
    for value, used in (("yes", 1), ("0", 0), ("TRUE", 1), ("", 0)):
        monkeypatch.setenv("BIGDL_TPU_PALLAS_STEM", value)
        before = calls["n"]
        on = m(x)
        assert calls["n"] - before == used, value
        torch.testing.assert_close(on, off, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [3, 7, 11])
def test_function_backward_matches_autograd_of_plain(k):
    kt, front, rear = _pads(k)
    rs = np.random.RandomState(k)
    x2 = torch.from_numpy(rs.randn(2, 5, 6, 12).astype(np.float32))
    wk = torch.from_numpy(rs.randn(kt, kt, 12, 7).astype(np.float32))
    b = torch.from_numpy(rs.randn(7).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 5, 6, 7).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x2, wk, b)]
    tsk.stem_conv(*leaves, front, rear).backward(g)
    refs = [t.clone().requires_grad_() for t in (x2, wk, b)]
    tsk.stem_conv_forward_plain(*refs, front, rear).backward(g)
    for got, want, name in zip(leaves, refs, ("x2", "wk", "bias")):
        _close(got.grad.numpy(), want.grad.numpy(), what=name)


def test_wrapper_refuses_what_it_does_not_take():
    x2 = torch.zeros(1, 4, 4, 12)
    wk = torch.zeros(4, 4, 12, 8)
    with pytest.raises(ValueError, match="sum to kt - 1"):
        tsk.stem_conv_forward(x2, wk, None, 2, 2)
    with pytest.raises(ValueError, match="does not fit"):
        tsk.stem_conv_forward(torch.zeros(1, 4, 4, 8), wk, None, 2, 1)
    with pytest.raises(ValueError, match="bias"):
        tsk.stem_conv_forward(x2, wk, torch.zeros(9), 2, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tsk.stem_conv_forward(x2.double(), wk, None, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tsk.stem_conv_forward(x2.transpose(1, 2), wk, None, 2, 1)
    with pytest.raises(ValueError, match="kernel % 4 == 3"):
        tnn.SpaceToDepthStemConvolution(3, 8, 5, device="cpu")


def test_ab_stem_tools_on_the_cpu(monkeypatch):
    """`tools/ab_stem.py` at a tiny size: the kernel route of the micro-
    benchmark goes through `stem_conv` (the plain version here, no launch),
    and the full loop runs `bench_resnet50` with the switch unset, then
    set, on weights from the same seed, and restores the switch."""
    from bigdl_tpu_torch.tools import ab_stem, bench
    calls = {"n": 0}
    plain = tsk.stem_conv_forward_plain

    def counted(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(tsk, "stem_conv_forward_plain", counted)
    micro = ab_stem.stem_micro(batch=2, hw=16, iters=1, device="cpu")
    assert calls["n"] == 2 and micro["kernel_launches"] == 0  # warm-up + 1
    assert micro["device"] == "cpu" and micro["dtype"] == "bfloat16"
    seen = []

    def fake_bench(**kw):
        seen.append((os.environ.get("BIGDL_TPU_PALLAS_STEM"),
                     kw["generator"].initial_seed()))
        return {"imgs_per_sec": 2.0, "ms_per_step": 1.0, "steps": 2,
                "device": "cpu", "losses": [1.0, 0.5]}
    monkeypatch.setattr(bench, "bench_resnet50", fake_bench)
    monkeypatch.setenv("BIGDL_TPU_PALLAS_STEM", "keep")
    loop = ab_stem.full_loop(warmup=1, iters=1, device="cpu")
    assert seen == [(None, 0), ("1", 0)]
    assert os.environ["BIGDL_TPU_PALLAS_STEM"] == "keep"
    assert loop["kernel_over_cudnn_imgs_per_sec"] == 1.0


def test_serving_bench_on_the_cpu(monkeypatch):
    from bigdl_tpu_torch.tools.bench import bench_resnet50_serving
    monkeypatch.delenv("BIGDL_TPU_PALLAS_STEM", raising=False)
    out = bench_resnet50_serving(batch_size=1, reps=1, device="cpu")
    assert out["timer"] == "host_clock" and out["device"] == "cpu"
    assert out["cudnn_stem_ms"] > 0 and out["stem_kernel_ms"] > 0
    assert "BIGDL_TPU_PALLAS_STEM" not in os.environ


def _emulate_tensor_core_stem(x2, wk, bias, front, rear):
    """The arithmetic of kernel 5's bf16 design (csrc/stem_conv.cu): the
    implicit GEMM with C2 zero-padded to 16, K in tap-major order, one
    16-deep step (f32 accumulation) a (dy, dx) tap; the bias added in f32
    and one rounding to bf16."""
    b, h, w, c2 = x2.shape
    kt, n_out = wk.shape[0], wk.shape[3]
    xp = torch.nn.functional.pad(x2.float(), (0, 16 - c2, front, rear,
                                              front, rear))
    wp = torch.zeros((kt, kt, 16, n_out))
    wp[:, :, :c2] = wk.float()
    acc = torch.zeros((b, h, w, n_out))
    for dy in range(kt):
        for dx in range(kt):
            acc = acc + xp[:, dy:dy + h, dx:dx + w] @ wp[dy, dx]
    if bias is not None:
        acc = acc + bias.float()
    return acc.bfloat16()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin", [1, 3])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tensor_core_stem_arithmetic_meets_the_kernel_limit(monkeypatch, k,
                                                            cin, with_bias):
    """Kernel 5's bf16 design, emulated at a ragged x2 of 113x115 (bf16
    inputs from numpy), against the plain version and against the JAX
    Pallas stem (`INTERPRET` set) on the same inputs: per element within
    phase 10(a)'s bf16 limit, 2**-7 |ref| + 1e-5 max|ref| (both round an
    f32 sum of the same exact products to bf16, summed in another
    order)."""
    monkeypatch.setattr(jsk, "INTERPRET", True)
    kt, front, rear = _pads(k)
    rs = np.random.RandomState(k * 10 + cin)
    x2 = rs.rand(1, 113, 115, 4 * cin).astype(np.float32)
    wk = (rs.randn(kt, kt, 4 * cin, 64) * 0.2).astype(np.float32)
    bias = rs.randn(64).astype(np.float32) if with_bias else None
    tx2, twk = (torch.from_numpy(a).bfloat16() for a in (x2, wk))
    tb = None if bias is None else torch.from_numpy(bias)
    got = _emulate_tensor_core_stem(tx2, twk, tb, front, rear).float()
    plain = tsk.stem_conv_forward_plain(tx2, twk, tb, front, rear)
    jax_out = jsk.stem_conv_forward(
        jnp.asarray(x2, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16),
        None if bias is None else jnp.asarray(bias), front, rear)
    assert plain.dtype == torch.bfloat16 and jax_out.dtype == jnp.bfloat16
    for ref in (plain.float(), torch.from_numpy(np.asarray(jax_out,
                                                           np.float32))):
        lim = 2 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        assert bool(((got - ref).abs() <= lim).all())


def test_bf16_training_hands_the_stem_kernel_bf16_weights(monkeypatch):
    """The bf16 training path (the benchmark's `set_compute_precision(
    "bfloat16")`: the model runs on bf16 copies of its f32 masters) calls
    the stem kernel's wrapper with bf16 x2 and bf16 wk and O = 64, the
    inputs that run its tensor-core design on the card."""
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.tools import bench
    seen = []
    wrapped = tsk.stem_conv_forward

    def record(x2, wk, bias, front, rear):
        seen.append((x2.dtype, wk.dtype, wk.shape[3]))
        return wrapped(x2, wk, bias, front, rear)
    monkeypatch.setattr(tsk, "stem_conv_forward", record)
    monkeypatch.setenv("BIGDL_TPU_PALLAS_STEM", "1")
    model = ResNet(class_num=10, depth=18, s2d_stem=True, device="cpu")
    out = bench.framework_throughput(model, (32, 32, 3), 10, batch_size=2,
                                     warmup=1, iters=1, sync=1, device="cpu")
    assert np.isfinite(out["losses"]).all()
    # two steps, and the step's FLOP count on a meta copy (shapes only)
    assert seen == [(torch.bfloat16, torch.bfloat16, 64)] * 3
