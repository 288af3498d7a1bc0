"""Port parity: `bigdl_tpu_torch.parallel.sequence` and the carry kernel's
plain version against `bigdl_tpu.parallel.sequence` and
`bigdl_tpu.ops.attention_kernel.flash_attention_carry`.

Inputs come from numpy with a fixed seed and go to both frameworks. The
port's meshes name the CPU several times (n shards in one process), the
twin of the virtual CPU devices the JAX package runs on here.

Tolerances:
- the carry's plain version against the Pallas carry kernel in interpret
  mode, and the port's ring and zigzag against JAX's Pallas-hop ring and
  zigzag (`INTERPRET` set): 3e-5 on outputs, the tolerance of
  `tests/test_attention.py`'s own Pallas-path tests (the same online
  softmax, blocked differently); 3e-4 on gradients of `sum(out**2)`;
- the three schemes against JAX's blockwise route: 1e-4, as
  `tests/test_attention.py`'s sequence-parallel tests hold JAX's schemes
  against naive attention;
- a shard wholly in the queries' causal future passes the carry through
  bit for bit, in both.

The CUDA kernel itself is held against its plain version on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from bigdl_tpu.ops import attention_kernel as jak
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel import sequence as jseq
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import attention_kernel as tak
from bigdl_tpu_torch.parallel import (Mesh, SequenceParallelAttention,
                                      build_mesh,
                                      make_sequence_parallel_attention,
                                      ring_attention, ulysses_attention,
                                      zigzag_inverse, zigzag_order,
                                      zigzag_ring_attention)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: this file runs JAX beside torch, and under the
    suite's parallel workers torch's intra-op pool and JAX's threads
    oversubscribe the cores (see tests/test_torch_recurrent.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

REPO = Path(__file__).resolve().parents[1]
PALLAS_TOL = 3e-5
GRAD_TOL = 3e-4
BLOCKWISE_TOL = 1e-4


def _arrays(shape, n=3, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _cpu_mesh(data, model=1):
    return build_mesh(data=data, model=model,
                      devices=["cpu"] * (data * model))


class TestCarryPlainVsPallas:
    @pytest.mark.parametrize("causal", [False, True])
    def test_two_shard_continuation(self, causal):
        """The continuation of `tests/test_attention.py`'s carry test (B1
        H2 T256 D32, 64-blocks): each hop's state and the finished output
        against the Pallas carry kernel in interpret mode."""
        q, k, v = _arrays((1, 2, 256, 32), seed=3, scale=0.3)
        jq, jk, jv = _j((q, k, v))
        tq, tk, tv = _t((q, k, v))
        js = jak.attention_state_init(jq)
        ts = tak.attention_state_init(tq)
        half = 128
        for k_off in (0, half):
            sl = slice(k_off, k_off + half)
            js = jak.flash_attention_carry(
                jq, jk[:, :, sl], jv[:, :, sl], js, causal=causal,
                k_offset=k_off, block_q=64, block_k=64, interpret=True)
            ts = tak.flash_attention_carry_plain(
                tq, tk[:, :, sl], tv[:, :, sl], ts, causal=causal,
                k_offset=k_off)
            for name, a, b in zip(("acc", "m", "l"), ts, js):
                _close(a.numpy(), b, PALLAS_TOL, f"{name} at {k_off}")
        out = tak.attention_state_finish(*ts)
        _close(out.numpy(), jak.attention_state_finish(*js), PALLAS_TOL)
        _close(out.numpy(), jak.naive_attention(jq, jk, jv, causal=causal),
               PALLAS_TOL)

    @pytest.mark.parametrize("tq,tk,q_off,k_off", [(100, 70, 0, 0),
                                                   (96, 130, 200, 64)])
    def test_ragged_and_offset(self, tq, tk, q_off, k_off):
        """Ragged Tq / Tk with global offsets, from a carried state: the
        JAX wrapper routes untiled shapes to its blockwise step, which the
        port's CUDA kernel replaces (it masks them itself)."""
        q, acc = _arrays((1, 2, tq, 16), n=2, seed=5)
        k, v, k0, v0 = _arrays((1, 2, tk, 16), n=4, seed=6)
        jstate = jak.blockwise_attention(
            *_j((q, k0, v0)), causal=True, q_offset=q_off, k_offset=0,
            finish=False)
        tstate = tuple(torch.from_numpy(np.array(x)) for x in jstate)
        want = jak.flash_attention_carry(
            *_j((q, k, v)), jstate, causal=True, q_offset=q_off,
            k_offset=k_off, block_q=64, block_k=64, interpret=True)
        got = tak.flash_attention_carry_plain(*_t((q, k, v)), tstate,
                                              causal=True, q_offset=q_off,
                                              k_offset=k_off)
        for name, a, b in zip(("acc", "m", "l"), got, want):
            _close(a.numpy(), b, PALLAS_TOL, name)

    def test_future_shard_passes_the_carry_through_bitwise(self):
        q, k, v = _arrays((1, 2, 128, 32), seed=7)
        jq, jk, jv = _j((q, k, v))
        # a carried state from a first hop over keys 0..127
        js = jak.flash_attention_carry(
            jq, jk, jv, jak.attention_state_init(jq), causal=True,
            block_q=64, block_k=64, interpret=True)
        ts = tuple(torch.from_numpy(np.array(x)) for x in js)
        # queries 0..127 against keys 128..255: wholly in their future
        want = jak.flash_attention_carry(jq, jk, jv, js, causal=True,
                                         k_offset=128, block_q=64,
                                         block_k=64, interpret=True)
        got = tak.flash_attention_carry_plain(*_t((q, k, v)), ts,
                                              causal=True, k_offset=128)
        for a, b, c in zip(got, want, js):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
            assert torch.equal(a, torch.from_numpy(np.array(c)))


@pytest.fixture
def jax_pallas_hops(monkeypatch):
    """JAX's ring and zigzag run the Pallas carry kernel (interpret mode)
    at every hop."""
    monkeypatch.setattr(jak, "INTERPRET", True)


class TestRingVsJaxPallas:
    @pytest.mark.parametrize("scheme,causal", [("ring", True),
                                               ("ring", False),
                                               ("zigzag", True)])
    def test_output_and_gradients(self, jax_pallas_hops, scheme, causal):
        arrays = _arrays((1, 2, 256, 32), seed=4, scale=0.3)
        jmesh_ = JaxMesh(np.array(jax.devices()[:4]), ("data",))
        jfn = jseq.make_sequence_parallel_attention(jmesh_, scheme,
                                                    causal=causal)
        tfn = make_sequence_parallel_attention(_cpu_mesh(4), scheme,
                                               causal=causal)
        jout, vjp = jax.vjp(jfn, *_j(arrays))
        _close(tfn(*_t(arrays)).numpy(), jout, PALLAS_TOL)
        jgrads = vjp(2 * jout)  # d sum(out**2) / d out = 2 out
        tin = [x.requires_grad_() for x in _t(arrays)]
        (tfn(*tin) ** 2).sum().backward()
        for name, x, g in zip("qkv", tin, jgrads):
            _close(x.grad.numpy(), g, GRAD_TOL, f"d{name}")


class TestSchemesVsJaxBlockwise:
    @pytest.mark.parametrize("scheme,causal,h", [
        ("ring", False, 8), ("ring", True, 8), ("ulysses", False, 8),
        ("ulysses", True, 8), ("zigzag", True, 4)])
    def test_eight_positions(self, scheme, causal, h):
        arrays = _arrays((2, h, 64, 16))
        jfn = jseq.make_sequence_parallel_attention(
            jmesh.build_mesh(data=8, model=1), scheme, causal=causal)
        tfn = make_sequence_parallel_attention(_cpu_mesh(8), scheme,
                                               causal=causal)
        out = tfn(*_t(arrays))
        _close(out.numpy(), jax.jit(jfn)(*_j(arrays)), BLOCKWISE_TOL)
        _close(out.numpy(), jak.naive_attention(*_j(arrays), causal=causal),
               BLOCKWISE_TOL)

    @pytest.mark.parametrize("scheme", ["ring", "zigzag", "ulysses"])
    def test_two_d_mesh_gradients(self, scheme):
        """A (data=4, model=2) mesh: the schemes run along `data` at model
        index 0; gradients of sum(out) for q, k and v against JAX's."""
        arrays = _arrays((1, 4, 32, 8))
        jfn = jseq.make_sequence_parallel_attention(
            jmesh.build_mesh(data=4, model=2), scheme, causal=True)
        tfn = make_sequence_parallel_attention(_cpu_mesh(4, 2), scheme,
                                               causal=True)
        jgrads = jax.grad(lambda *a: jax.jit(jfn)(*a).sum(),
                          argnums=(0, 1, 2))(*_j(arrays))
        tin = [x.requires_grad_() for x in _t(arrays)]
        tfn(*tin).sum().backward()
        for name, x, g in zip("qkv", tin, jgrads):
            _close(x.grad.numpy(), g, BLOCKWISE_TOL, f"d{name}")

    def test_class_wrapper(self):
        arrays = _arrays((1, 2, 32, 8), seed=9)
        attn = SequenceParallelAttention(_cpu_mesh(4), "ring", causal=True)
        assert attn.axis_name == "data" and attn.mesh.shape["data"] == 4
        _close(attn(*_t(arrays)).numpy(),
               jak.naive_attention(*_j(arrays), causal=True), BLOCKWISE_TOL)


class TestPerShardPrograms:
    def test_kernel_hops_per_call(self, monkeypatch):
        """Ring runs n^2 hops (the wholly masked ones too) and zigzag
        n(2n+1); Ulysses runs none. Counted through the wrapper that
        launches kernel 2 on a CUDA tensor."""
        calls = []
        real = tak.flash_attention_carry

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(tak, "flash_attention_carry", counting)
        mesh = _cpu_mesh(4)
        arrays = _t(_arrays((1, 4, 64, 8)))
        for scheme, want in (("ring", 16), ("zigzag", 36), ("ulysses", 0)):
            calls.clear()
            make_sequence_parallel_attention(mesh, scheme,
                                             causal=True)(*arrays)
            assert len(calls) == want, scheme

    def test_shard_lists_in_and_out(self):
        arrays = _arrays((1, 4, 32, 8), seed=11)
        q, k, v = (list(torch.from_numpy(a).chunk(4, dim=2))
                   for a in arrays)
        want = jak.naive_attention(*_j(arrays), causal=True)
        for fn in (ring_attention, ulysses_attention):
            outs = fn(q, k, v, causal=True)
            assert len(outs) == 4
            _close(torch.cat(outs, dim=2).numpy(), want, BLOCKWISE_TOL)
        order = zigzag_order(4, 32)
        zq, zk, zv = (list(torch.from_numpy(a[:, :, order]).chunk(4, dim=2))
                      for a in arrays)
        outs = zigzag_ring_attention(zq, zk, zv)
        got = torch.cat(outs, dim=2)[:, :, zigzag_inverse(4, 32)]
        _close(got.numpy(), want, BLOCKWISE_TOL)

    def test_no_grad_path_matches_grad_path(self):
        arrays = _arrays((1, 2, 32, 8), seed=12)
        fn = make_sequence_parallel_attention(_cpu_mesh(4), "zigzag",
                                              causal=True)
        with torch.no_grad():
            plain = fn(*_t(arrays))
        tracked = fn(*[x.requires_grad_() for x in _t(arrays)])
        assert tracked.requires_grad
        _close(tracked.detach().numpy(), plain.numpy(), 1e-6)

    def test_bf16_shards_keep_their_dtype(self):
        arrays = _t(_arrays((1, 2, 32, 8), seed=13))
        fn = make_sequence_parallel_attention(_cpu_mesh(4), "ring",
                                              causal=True)
        out = fn(*[x.bfloat16() for x in arrays])
        assert out.dtype == torch.bfloat16
        ref = tak.naive_attention(*arrays, causal=True)
        assert float((out.float() - ref).abs().max()) < 2e-2


class TestErrorsAndLayout:
    @pytest.mark.parametrize("n,t", [(4, 64), (8, 64), (2, 12), (1, 6)])
    def test_zigzag_order_matches_jax(self, n, t):
        np.testing.assert_array_equal(zigzag_order(n, t),
                                      jseq.zigzag_order(n, t))
        np.testing.assert_array_equal(zigzag_inverse(n, t),
                                      jseq.zigzag_inverse(n, t))

    def test_zigzag_refuses_non_causal(self):
        fn = make_sequence_parallel_attention(_cpu_mesh(8), "zigzag",
                                              causal=False)
        with pytest.raises(ValueError, match="causal"):
            fn(*_t(_arrays((1, 2, 64, 8))))
        with pytest.raises(ValueError, match="causal"):
            zigzag_ring_attention(*([torch.zeros(1, 1, 4, 2)] * 2
                                    for _ in range(3)), causal=False)

    def test_ulysses_head_divisibility(self):
        fn = make_sequence_parallel_attention(_cpu_mesh(8), "ulysses")
        with pytest.raises(ValueError, match="n_head"):
            fn(*_t(_arrays((1, 4, 64, 8))))

    @pytest.mark.parametrize("scheme,t", [("ring", 62), ("ulysses", 62),
                                          ("zigzag", 36)])
    def test_sequence_divisibility(self, scheme, t):
        fn = make_sequence_parallel_attention(_cpu_mesh(4), scheme,
                                              causal=True)
        with pytest.raises(ValueError, match="divide"):
            fn(*_t(_arrays((1, 4, t, 8))))

    def test_bad_scheme_axis_and_shapes(self):
        mesh = _cpu_mesh(4)
        with pytest.raises(ValueError, match="scheme"):
            make_sequence_parallel_attention(mesh, "tree")
        with pytest.raises(ValueError, match="axis"):
            make_sequence_parallel_attention(mesh, "ring", axis_name="seq")
        q = torch.zeros(1, 2, 16, 8)
        with pytest.raises(ValueError, match="shape"):
            make_sequence_parallel_attention(mesh)(q, q[:, :1], q)


class TestMesh:
    def test_build_mesh_shapes(self):
        mesh = build_mesh(data=4, model=2, devices=["cpu"] * 8)
        assert isinstance(mesh, Mesh)
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 4, "model": 2}
        assert mesh.devices.shape == (4, 2)
        assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
        assert build_mesh(devices=["cpu"] * 3).shape == {"data": 3,
                                                          "model": 1}
        with pytest.raises(ValueError):
            build_mesh(data=3, devices=["cpu"] * 4)

    def test_default_mesh_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_mesh()


class TestCarryWrapper:
    def _state(self, q, seed=1):
        acc, = _arrays(tuple(q.shape), n=1, seed=seed)
        rs = np.random.RandomState(seed)
        m = torch.from_numpy(rs.randn(*q.shape[:3]).astype(np.float32))
        l = torch.from_numpy(rs.rand(*q.shape[:3]).astype(np.float32) + 1)
        return torch.from_numpy(acc), m, l

    def test_cpu_runs_the_plain_version_uncounted(self):
        q, k, v = _t(_arrays((1, 2, 24, 8)))
        state = self._state(q)
        before = tak.flash_attention_carry.launches
        got = tak.flash_attention_carry(q, k, v, state, causal=True,
                                        q_offset=16, k_offset=8)
        want = tak.flash_attention_carry_plain(q, k, v, state, True, None,
                                               16, 8)
        assert tak.flash_attention_carry.launches == before
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    def test_inplace_writes_the_carry(self):
        q, k, v = _t(_arrays((1, 2, 24, 8)))
        state = self._state(q)
        copy = tuple(t.clone() for t in state)
        got = tak.flash_attention_carry(q, k, v, state, inplace=True)
        want = tak.flash_attention_carry_plain(q, k, v, copy)
        assert all(a is b for a, b in zip(got, state))
        for a, b in zip(state, want):
            assert torch.equal(a, b)

    def test_rejects_bad_carry_and_devices(self):
        q, k, v = _t(_arrays((1, 2, 24, 8)))
        acc, m, l = self._state(q)
        with pytest.raises(ValueError, match="carry m"):
            tak.flash_attention_carry(q, k, v, (acc, m[..., :3], l))
        with pytest.raises(ValueError, match="carry acc"):
            tak.flash_attention_carry(q, k, v, (acc.double(), m, l))
        with pytest.raises(ValueError, match="carry"):
            tak.flash_attention_carry(q, k, v, (acc, m))
        meta = [x.to("meta") for x in (q, k, v, acc, m, l)]
        with pytest.raises(NotImplementedError):
            tak.flash_attention_carry(*meta[:3], tuple(meta[3:]))

    def test_library_name_follows_the_shared_header(self, monkeypatch,
                                                    tmp_path):
        (tmp_path / "k.cu").write_text('#include "t.cuh"')
        header = tmp_path / "t.cuh"
        header.write_text("// a")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        first = _build._lib_path("k")
        header.write_text("// b")
        assert _build._lib_path("k") != first
        assert "flash_attention_carry" in _build.KERNELS
        assert (REPO / "bigdl_tpu_torch/csrc/flash_attention_carry.cu").exists()


def test_port_imports_no_jax():
    """Every module of `bigdl_tpu_torch` imports in a fresh interpreter
    without pulling in `jax` or anything of `bigdl_tpu`."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bigdl_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'bigdl_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'bigdl_tpu.')) or m == 'bigdl_tpu')\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 30


def test_bench_attention_reports_every_part():
    """`tools/bench.py --model attention` at tiny lengths on the CPU: the
    flash forward, forward plus backward, naive attention up to its limit,
    and ring against zigzag over 4 shards on the one device."""
    from bigdl_tpu_torch.tools import bench
    res = bench.bench_attention(device="cpu", lengths=(64, 128),
                                naive_max=64, ring_len=100, reps=1)
    assert res["timer"] == "host_clock" and res["dtype"] == "bfloat16"
    assert [r["seq"] for r in res["flash"]] == [64, 128]
    assert [r["seq"] for r in res["flash_fwd_bwd"]] == [64, 128]
    assert [r["seq"] for r in res["naive"]] == [64]
    sp = res["sequence_parallel"]
    assert sp["shards"] == 4 and sp["one_device"] and sp["seq"] == 96
    assert all(sp[s]["ms"] > 0 for s in ("ring", "zigzag"))
    with pytest.raises(ValueError, match="CUDA"):
        bench.profile_attention(device="cpu")
