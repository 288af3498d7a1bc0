"""Training throughput of the port (counterpart of
`bigdl_tpu/tools/bench_cli.py` `_framework_throughput`, `bench_resnet50`
and its transformer-LM block), and its long-context attention figures
(`bench_attention`).

The model trains through `DistriOptimizer` with `SGD(learning_rate=0.01,
momentum=0.9)` and bf16 compute with f32 masters, on ONE synthetic batch
from `np.random.RandomState(0)` that is placed on the device once and
reused every step (the reference's resident batch). Steps are queued
without waiting and the host syncs every `sync` steps; the rate is
`sync * records` over the median interval between sync points after the
warm-up. The result also carries every step's loss.

- ResNet-50: b128 images at 224x224x3, `ClassNLLCriterion`; imgs/s.
- TransformerLM (`--model lm`): vocab 1024, embed 512, 4 layers, 8 heads,
  b8 at T=2048, `TimeDistributedCriterion(ClassNLLCriterion())` with the
  reference's default `size_average=False` (a sum over T, so the loss
  grows with T and this recipe diverges after a few steps, in the
  reference as here); tokens/s.

    python -m bigdl_tpu_torch.tools.bench                       # ResNet-50
    python -m bigdl_tpu_torch.tools.bench --model lm            # the LM
    python -m bigdl_tpu_torch.tools.bench [--model lm] --profile
    python -m bigdl_tpu_torch.tools.bench --model attention [--profile]
    python -m bigdl_tpu_torch.tools.bench --model serve [--profile]
    python -m bigdl_tpu_torch.tools.bench --model serve_fleet [--crash]
    python -m bigdl_tpu_torch.tools.bench --model replay_invariance \
        [--replay-model mlp|resnet50] [--device cpu]
    python -m bigdl_tpu_torch.tools.bench --model int8_serving [--profile]
    python -m bigdl_tpu_torch.tools.bench --model inception_v1 [--profile]
    python -m bigdl_tpu_torch.tools.bench --model lenet|inception_v2|vgg16
    python -m bigdl_tpu_torch.tools.bench --model ptb_lstm [--profile]
    python -m bigdl_tpu_torch.tools.bench --model wide_n_deep [--profile]
    python -m bigdl_tpu_torch.tools.bench --nproc 2 [--backend gloo|nccl]
    python -m bigdl_tpu_torch.tools.bench --model wide_n_deep --nproc 2
    python -m bigdl_tpu_torch.tools.bench --model lm --nproc 4 --model-axis 2
    python -m bigdl_tpu_torch.tools.bench --model lm --telemetry out/lm
    python -m bigdl_tpu_torch.tools.bench --telemetry out/r --attribution
    python -m bigdl_tpu_torch.tools.bench --model input_pipeline \
        [--input-cost-ms 20] [--device cpu]
    python -m bigdl_tpu_torch.tools.bench --chaos [--chaos-crash-at N]
    python -m bigdl_tpu_torch.tools.bench --device-loss [--device cpu]

`--chaos` is the job-level crash drill (`bench_chaos`: a transient
`train.step` fault at step 8 of 16 of an MNIST-shaped MLP checkpointed
every 4, the retry policy's reload; MTTR off the telemetry stream) and
`--device-loss` the elastic drill (`bench_chaos_device_loss`: the MLP
over a 2-worker `SimulatedCluster` on two slots of the device, worker1
lost at step 5 and back at step 12, bucketing on; MTTR, replayed
batches, whether it grew back, the degraded throughput). Each prints one
JSON line with the reference's keys and the `device` it ran on.

`--telemetry STEM` (any training path) attaches a `Telemetry` with the
gradient norms and a `SpanTracer` to every training run: the records go
to `STEM.jsonl` (one `run_start`, a `step` record a sync point, a
`run_end`; rank 0 of a data-parallel run), the spans to
`STEM.trace.json` (other ranks: `STEM.rank<r>.trace.json`), which
Perfetto opens. The timed numbers then include what the instrumentation
costs. `--attribution` adds `metrics_cli report` of each run's stream on
stderr (and without `--telemetry` streams to `bench_attribution` in the
working directory).

`--model input_pipeline [--input-cost-ms X]` is the reference's input
pipeline A/B (`bench_input_pipeline`): an MNIST-shaped MLP through
`LocalOptimizer` over 16 seeded batches of 256, a sleep of X ms a batch
in the transformer chain standing in for decode and augmentation, run in
short serial and prefetched (`set_prefetch`) segments, strictly
alternated; one JSON line with both rates and the median of the pairs'
ratios.

`--nproc N` (ResNet-50 or Wide&Deep) is the data-parallel configuration:
it starts N ranks, one process each (`Engine.init(distributed=True)`,
NCCL by default on cards, gloo with `--backend gloo`, which lets ranks
share one card), each with its resident shard of one global batch (b128
or b1024 split N ways, rows `rank * B/N` on), as the reference's
`bench_cli.py` shards one batch over its mesh. The report: global imgs/s
(records/s), each rank's rate and ms a step, mfu of the global FLOPs over
N peaks, the loss of every step (the ranks' mean), and a step's
collectives on each rank (gradient all-reduces, one a bucket, and their
bytes; BN all-reduces), and the kernel launches on each rank (BN+ReLU a
step for ResNet-50; every kernel's count for Wide&Deep).

`--model lm --nproc N --model-axis M` is the LM recipe over a (N/M, M)
mesh of ranks (`Engine.get_mesh`), tensor parallel on the model axis
(`DistriOptimizer`'s default `ShardingRules()`): the global b8 at T=2048
split over the N/M data replicas (b4 each at (2, 2)), the ranks of a
model group on the same rows, L2 clipping at 1.0 (the unclipped recipe
diverges). It reports ms a step and global tokens/s, and on each rank the
all-gathers ("gather") and gradient all-reduces ("grad") a step with their
bytes, the bytes of parameters plus optimizer state the rank holds
(`stored_bytes`, after the first step), and the launches of kernels 1, 3
and 4 a step. With `--backend gloo` the ranks share one card.

The feed-forward zoo (`--model lenet | inception_v1 | inception_v2 |
vgg16`) trains with the same recipe (`ClassNLLCriterion`, sync every 8) at
the reference's batch sizes (`bench_cli.py` `bench_baseline_configs`,
`examples/perf.py`): LeNet-5 at b512 on 28x28 images with 10 classes;
`Inception_v1_NoAuxClassifier(1000, s2d_stem=True)` at b64 on 224x224x3,
the stem through kernel 5 when `BIGDL_TPU_PALLAS_STEM` is set, as in the
reference; `Inception_v2_NoAuxClassifier(1000)` and `Vgg_16(1000)` at
b32. Dropout draws from the optimizer's step generator. `--profile` works
for both Inceptions; it adds the `torch.cat` copies and the copies and
casts as kinds of their own, the BN+ReLU gradient copies a step
(`BnReluFunction.g_copies`: 0 where every `Concat` slice is read in
place) and the LRN layers' device time (every zoo
model takes it).

`--model ptb_lstm` is `BASELINE.md` config 4, the PTB LSTM language
model (`PTBModel(10001, 200, 10001)`, b64, 20 time steps, 1-based seeded
ids, `TimeDistributedCriterion(ClassNLLCriterion())`), through the same
recipe; it reports records/s (sequences, the reference's unit) and
tokens/s. Its time loop is a Python loop of 20 steps; no kernel of the
port runs on this path.

`--model wide_n_deep` is `BASELINE.md` config 5, `WideAndDeep(2,
wide_dim=100, embed_vocabs=(10, 10), embed_dim=4, cont_dim=3)` at b1024
(`bench_cli.py:1645-1656`): one resident four-tensor batch (0-based wide
ids, wide values of 1, 1-based categorical ids, continuous features; the
model takes their 1-based `Table`), labels 1 or 2, the same recipe; it
reports records/s. With `--nproc N` each rank holds its rows of all four
tensors. No kernel of the port runs on this path.

`--model int8_serving` is the reference's int8 serving A/B
(`bench_int8_serving`): ResNet-50 (plain stem) at b256 on 224x224x3 in
bf16, weight-only int8 and full int8 (`nn/quantized.py`), 10 timed
forwards each: images/s, the parameters' MB, the launches a forward of
kernel 6, `torch._int_mm` and the weight-only cuBLAS / cuDNN calls, and
each int8 variant's top-1 agreement with bf16;
`bench_int8_serving(model="lenet", device="cpu")` runs it at the
reference's CPU scale (LeNet-5 on 28x28). With `--profile`, each variant's device time by kind of kernel (the
int8 GEMMs, the im2col's `torch.cat` and the casts on their own) and by
launching op.

`--model serve` times one b32 forward of the served ResNet-50
(`LocalPredictor` over `ResNet50(class_num=1000, s2d_stem=True)`, f32,
TF32 off) with the stem kernel off and on; with `--profile`, the device
time by kind of kernel with it on.

`--model serve_fleet [--crash]` is the reference's serving-fleet drill
(`bench_serve_fleet`) over that served ResNet-50 with the stem kernel on:
3 replicas of one device behind a `ServingFleet`, 6 closed-loop clients x
40 requests with session affinity in windows of 4; with `--crash`,
replica1 is killed through `serve.replica_crash` once 25-75% of the
requests resolved. It prints the outcome tallies, reroutes, drains, MTTR
and degraded throughput off the telemetry stream, requests/s and the
p50/p99 latency.

Every path also reports its FLOP count and `mfu`: `flops_per_step` (a
training step, counted on the step the optimizer runs, on a copy of the
model), `flops_per_forward` (serving) and `flops` (each attention call),
all from `observability.costs.count_flops`, counted once before the timed
window; `mfu` is that count over the measured time, against
`costs.peak_flops` of the card (the dense bf16 peak; None off the
registry, on the CPU for one).

prints one JSON object. `--profile` gives device time by kind of kernel,
and by the op that launched each kernel (`ms_per_step_by_op`: the
autograd node of a backward kernel, `VarBackward0` and the like, else the
outermost aten op, `aten::var` and the like). The benchmark needs a CUDA device unless called with `device="cpu"`; the
profile always does.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.nn.conv import STEM_ENV
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
from bigdl_tpu_torch.optim.local_optimizer import _meta, step_flops
from bigdl_tpu_torch.parallel import collectives


def _resident(x, device: torch.device):
    """An array, or a list of them (a multi-input batch), on `device`."""
    if isinstance(x, (list, tuple)):
        return [_resident(v, device) for v in x]
    return torch.from_numpy(x).to(device)


def _resident_optimizer(model: torch.nn.Module, x, y: np.ndarray, criterion,
                        device: torch.device) -> DistriOptimizer:
    """The benchmark's optimizer over one batch (x, y) placed on `device`
    once; x is an array or a list of them (the model then takes the
    1-based `Table` of them)."""
    batch = MiniBatch(_resident(x, device), _resident(y, device))
    opt = DistriOptimizer(model, LocalDataSet([batch]), criterion,
                          devices=[device])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    return opt.set_compute_precision("bfloat16")


def _image_batch(in_shape: Sequence[int], n_class: int, batch_size: int):
    rs = np.random.RandomState(0)
    x = rs.rand(batch_size, *in_shape).astype(np.float32)
    y = (rs.randint(0, n_class, size=batch_size) + 1).astype(np.int32)
    return x, y


def _token_batch(vocab: int, seq: int, batch_size: int):
    """1-based tokens [B, T+1] from `RandomState(0)`: inputs are the first
    T, targets the last T (the reference's next-token batch)."""
    rs = np.random.RandomState(0)
    toks = rs.randint(1, vocab + 1, (batch_size, seq + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _mfu(flops, ms: float, device: torch.device):
    """`costs.mfu` of `flops` in `ms` on `device` (None on the CPU)."""
    return costs.mfu(flops, ms * 1e-3, device_kind=_device_name(device))


def _timed_run(opt: DistriOptimizer, warmup: int, iters: int, sync: int,
               on_step=None):
    """Run `warmup + iters` steps, syncing every `sync` (`on_step(state)`
    after each); returns the median sync-window length (s) after the
    warm-up and every step's loss."""
    opt.set_sync_interval(sync)
    opt.set_end_when(max_iteration(warmup + iters))
    times, losses = [], []

    def hook(state):
        if on_step is not None:
            on_step(state)
        losses.append(opt.last_loss)
        if state["neval"] % sync == 0:  # the device has drained here
            times.append(time.perf_counter())
        if state["neval"] == warmup:
            opt.metrics.reset()  # keep the warm-up out of the phase table

    opt.set_iteration_hook(hook)
    with _bench_telemetry(opt):
        opt.optimize()
    intervals = np.diff(times[warmup // sync - 1:])
    return float(np.median(intervals)), [float(v) for v in losses]


#: the environment variable `--telemetry STEM` sets (the ranks a
#: data-parallel run starts inherit it)
TELEMETRY_ENV = "BIGDL_TPU_TELEMETRY"
#: set by `--attribution`: each telemetry-wired run prints its report
ATTRIBUTION_ENV = "BIGDL_TPU_ATTRIBUTION"


@contextlib.contextmanager
def _bench_telemetry(opt: DistriOptimizer):
    """With `$BIGDL_TPU_TELEMETRY` set to a stem (`--telemetry STEM`), the
    run inside streams its records to `STEM.jsonl` (appended) through a
    `Telemetry` with the grad norms, and its spans to `STEM.trace.json`
    (written when the run ends, failed or not); a rank other than 0 of a
    data-parallel run writes `STEM.rank<r>.trace.json` (rank 0 alone
    writes records). Without the variable, nothing."""
    stem = os.environ.get(TELEMETRY_ENV)
    if not stem:
        yield
        return
    from bigdl_tpu_torch.observability import (JsonlSink, SpanTracer,
                                               Telemetry)
    attribution = os.environ.get(ATTRIBUTION_ENV)
    rank = collectives.rank()
    if rank:
        stem = f"{stem}.rank{rank}"
    telemetry = Telemetry(JsonlSink(stem + ".jsonl"), grad_norms=True) \
        if rank == 0 else None
    tracer = SpanTracer(process_name=f"bench[rank {rank}]")
    opt.set_telemetry(telemetry)
    opt.set_tracer(tracer)
    try:
        yield
    finally:
        if telemetry is not None:
            telemetry.close()
        tracer.export(stem + ".trace.json")
        opt.set_telemetry(None)
        opt.set_tracer(None)
        if attribution and telemetry is not None:
            # --attribution: the run's report (step summary with MFU,
            # the phase table, the compile records) on stderr
            from bigdl_tpu_torch.tools import metrics_cli
            metrics_cli.report(stem + ".jsonl", out=sys.stderr)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def framework_throughput(model: torch.nn.Module, in_shape: Sequence[int],
                         n_class: int, batch_size: int, warmup: int,
                         iters: int, sync: int = 4, device=None, *,
                         batch=None, criterion=None) -> Dict:
    """Train `model` (already on `device`) for `warmup + iters` steps on a
    resident batch of NHWC `in_shape` images (or on `batch`, an (x, y)
    pair of arrays, under `criterion`; default `ClassNLLCriterion`);
    returns records/s (`imgs_per_sec`), ms/step, the losses, the step's
    FLOP count (`step_flops`, off the clock) and mfu. `warmup` and
    `iters` are rounded to whole sync windows."""
    device = resolve_device(device)
    sync = math.gcd(math.gcd(warmup, iters), sync)  # windows tile the run
    if batch is None:
        batch = _image_batch(in_shape, n_class, batch_size)
    opt = _resident_optimizer(model, *batch,
                              criterion or ClassNLLCriterion(), device)
    flops = step_flops(opt)
    window_s, losses = _timed_run(opt, warmup, iters, sync)
    ms = 1e3 * window_s / sync
    return {"imgs_per_sec": sync * batch_size / window_s,
            "ms_per_step": ms, "flops_per_step": flops,
            "mfu": _mfu(flops, ms, device),
            "batch_size": batch_size, "steps": warmup + iters,
            "warmup": warmup, "sync": sync, "losses": losses,
            "device": _device_name(device)}


def lm_throughput(model: torch.nn.Module, vocab: int, seq: int,
                  batch_size: int, warmup: int, iters: int, sync: int = 4,
                  device=None) -> Dict:
    """Train the `TransformerLM` `model` (already on `device`) for
    `warmup + iters` steps on a resident batch of `batch_size` sequences
    of `seq` tokens; returns tokens/s, ms/step, the losses, the step's
    FLOP count and mfu."""
    device = resolve_device(device)
    sync = math.gcd(math.gcd(warmup, iters), sync)
    opt = _resident_optimizer(model, *_token_batch(vocab, seq, batch_size),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              device)
    flops = step_flops(opt)
    window_s, losses = _timed_run(opt, warmup, iters, sync)
    ms = 1e3 * window_s / sync
    return {"tokens_per_sec": sync * batch_size * seq / window_s,
            "ms_per_step": ms, "flops_per_step": flops,
            "mfu": _mfu(flops, ms, device),
            "batch_size": batch_size, "seq": seq, "steps": warmup + iters,
            "warmup": warmup, "sync": sync, "losses": losses,
            "device": _device_name(device)}


def bench_resnet50(batch_size: int = 128, warmup: int = 216,
                   iters: int = 648, sync: int = 216, device=None,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """`ResNet50(class_num=1000, s2d_stem=True)` at 224x224x3, random
    weights from `generator` (default seed 0)."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    device = resolve_device(device)
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    return framework_throughput(model, (224, 224, 3), 1000, batch_size,
                                warmup, iters, sync=sync, device=device)


def _collectives_ms(opt: DistriOptimizer, reps: int = 5) -> Dict:
    """Host ms (device drained, ranks aligned by a barrier) of one step's
    collectives issued alone, the median of `reps`: the gradient buckets'
    all-reduces over copies of the parameters, and the BN statistics'
    all-reduces (4 a BN layer, at their sizes)."""
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    dev = opt.device
    grads = [p.detach().clone() for p in opt.model.parameters()]
    bn = [torch.zeros(n, device=dev)
          for m in opt.model.modules() if isinstance(m, BatchNormalization)
          for n in (m.n_output + 1, m.n_output, m.n_output, m.n_output + 1)]

    def median_ms(fn):
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            collectives.barrier()
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    return {"grad_allreduce_ms": median_ms(
                lambda: collectives.bucket_all_reduce_mean(
                    grads, opt.bucket_plan.buckets, collectives.world_size())),
            "bn_allreduce_ms": median_ms(
                lambda: [collectives.all_reduce_(t, "bn") for t in bn])}


def _rank_shard(batch_size: int):
    """(world, rank, local batch, this rank's rows) of a global batch."""
    world, rank = collectives.world_size(), collectives.rank()
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not split over {world} "
                         "ranks")
    local = batch_size // world
    return world, rank, local, slice(rank * local, (rank + 1) * local)


def _rank_run(opt: DistriOptimizer, local: int, warmup: int, iters: int,
              sync: int, on_step=None) -> Dict:
    """The timed part of a data-parallel rank: the step's FLOPs (its
    shard's), `warmup + iters` steps syncing every `sync`; this rank's ms
    a step, records/s, losses, collectives a step by kind (not the
    broadcasts before the run nor the gathers after it), gradient buckets,
    and every kernel's launches a step during the run."""
    flops = step_flops(opt)
    sync = math.gcd(math.gcd(warmup, iters), sync)
    before = _kernel_launches()
    collectives.reset_counts()
    window_s, losses = _timed_run(opt, warmup, iters, sync, on_step)
    steps = warmup + iters
    return {"rank": collectives.rank(), "world": collectives.world_size(),
            "local_batch": local, "ms_per_step": 1e3 * window_s / sync,
            "records_per_sec": sync * local / window_s,
            "flops_per_step": flops, "losses": losses,
            "collectives_per_step": {
                k: v / steps for k, v in collectives.counts.items()
                if not k.startswith(("broadcast", "unshard"))},
            "n_buckets": len(opt.bucket_plan) if opt.bucket_plan else 0,
            "kernel_launches_per_step": {
                k: (v - before[k]) / steps
                for k, v in _kernel_launches().items()},
            "steps": steps, "warmup": warmup, "sync": sync,
            "device": _device_name(opt.device)}


def resnet50_rank(batch_size: int = 128, warmup: int = 8, iters: int = 16,
                  sync: int = 8, device=None, seed: int = 0) -> Dict:
    """This rank's part of the data-parallel ResNet-50 benchmark, in a
    process that has joined the process group: the global batch
    `batch_size` (seeded as `bench_resnet50`'s) split over the ranks, this
    rank's rows resident on `device`; `_rank_run`'s figures (records/s as
    `imgs_per_sec`), the BN+ReLU launches a step, and the time of a
    step's collectives issued alone (`_collectives_ms`, after the run)."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    world, _, local, rows = _rank_shard(batch_size)
    device = resolve_device(device)
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=torch.Generator().manual_seed(seed))
    x, y = _image_batch((224, 224, 3), 1000, batch_size)
    opt = _resident_optimizer(model, x[rows], y[rows], ClassNLLCriterion(),
                              device)
    res = _rank_run(opt, local, warmup, iters, sync)
    res["imgs_per_sec"] = res.pop("records_per_sec")
    launches = res["kernel_launches_per_step"]
    res["bn_relu_launches_per_step"] = {"fwd": launches["bn_relu_fwd"],
                                        "bwd": launches["bn_relu_bwd"]}
    res["collectives_alone"] = _collectives_ms(opt) if world > 1 else None
    return res


#: the tensor-parallel LM recipe (`lm_rank`): `bench_transformer_lm`'s
#: vocabulary and sequence, and the L2 clipping without which it diverges
LM_TP = {"vocab": 1024, "seq": 2048, "clip": 1.0}


def lm_rank(batch_size: int = 8, warmup: int = 2, iters: int = 6,
            sync: int = 2, device=None, *, model_axis: int = 1) -> Dict:
    """This rank's part of the LM benchmark over a (world / `model_axis`,
    `model_axis`) mesh of ranks, in a process that has joined the process
    group: the global batch `batch_size` of `LM_TP` sequences (seeded as
    `bench_transformer_lm`'s) split over the data replicas, this replica's
    rows resident on `device`; the LM from seed 0, tensor parallel over
    the model axis, clipped as `LM_TP` says. `_rank_run`'s figures, the
    launches of kernels 1, 3 and 4 a step, and the bytes of parameters
    and optimizer state this rank holds after the first step."""
    from bigdl_tpu_torch.parallel.sharding import stored_bytes
    from bigdl_tpu_torch.utils.engine import Engine
    device = resolve_device(device)
    mesh = Engine.get_mesh(model=model_axis)
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(f"batch {batch_size} does not split over {data} "
                         "data replicas")
    local = batch_size // data
    rows = slice(mesh.data_index * local, (mesh.data_index + 1) * local)
    seq = LM_TP["seq"]
    x, y = _token_batch(LM_TP["vocab"], seq, batch_size)
    model = _lm(LM_TP["vocab"], device, torch.Generator().manual_seed(0))
    batch = MiniBatch(_resident(x[rows], device), _resident(y[rows], device))
    opt = DistriOptimizer(model, LocalDataSet([batch]),
                          TimeDistributedCriterion(ClassNLLCriterion()),
                          mesh=mesh, devices=[device])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_gradient_clipping_by_l2_norm(LM_TP["clip"])
    held = {}

    def note(state):
        if state["neval"] == 1:
            held["stored_param_bytes"] = stored_bytes(opt.model)
            held["stored_bytes"] = stored_bytes(opt.model, opt.opt_state)
            held["sharded"] = sorted(opt.sharded.dims) if opt.sharded \
                else []

    res = _rank_run(opt, local, warmup, iters, sync, note)
    res["tokens_per_sec"] = res.pop("records_per_sec") * seq
    res.update(seq=seq, mesh=mesh.shape,
               coords=[mesh.data_index, mesh.model_index], **held)
    launches = res["kernel_launches_per_step"]
    res["flash_launches_per_step"] = {
        k: launches[k] for k in ("flash_attention_fwd",
                                 "flash_attention_bwd_dq",
                                 "flash_attention_bwd_dkv")}
    return res


def _dp_child(args) -> None:
    """A rank started by `bench_dp`: joins the group from the launcher's
    environment, runs the model's rank function (`resnet50_rank`,
    `wide_n_deep_rank`, `lm_rank`), prints its result."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init(distributed=True, backend=args.backend)
    rank_fn = {"resnet50": resnet50_rank,
               "wide_n_deep": wide_n_deep_rank,
               "lm": functools.partial(lm_rank,
                                       model_axis=args.model_axis)
               }[args.model]
    try:
        res = rank_fn(args.batch_size, args.warmup, args.iters, args.sync,
                      device=args.device)
    finally:
        Engine.shutdown()
    print("DP_RANK " + json.dumps(res), flush=True)


#: the configurations `bench_dp` runs, and their global batch sizes
DP_MODELS = {"resnet50": 128, "wide_n_deep": 1024, "lm": 8}


def bench_dp(model: str = "resnet50", nproc: int = 2,
             batch_size: Optional[int] = None, warmup: int = 8,
             iters: int = 16, sync: int = 8, backend: Optional[str] = None,
             device: str = "cuda", timeout_s: float = 900.0, *,
             model_axis: int = 1) -> Dict:
    """`model` ("resnet50", "wide_n_deep" or "lm") over `nproc` ranks on
    this machine, one process each (`resnet50_rank`, `wide_n_deep_rank`,
    `lm_rank`), at the global batch `batch_size` (default the
    configuration's, `DP_MODELS`): rank r on `cuda:{r % device_count}`
    (or the CPU with `device="cpu"`), `backend` as `Engine.init` takes it;
    the LM with `model_axis` ranks on the model axis. The kernels are
    built here before any rank starts. Returns the global figures and
    each rank's."""
    import socket
    import subprocess
    import sys
    from pathlib import Path
    if device == "cuda":
        resolve_device(device)  # raises without a card
        from bigdl_tpu_torch.ops import _build
        _build.build_kernels()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    batch_size = batch_size or DP_MODELS[model]
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.tools.bench",
           "--dp-child", "--model", model,
           "--batch-size", str(batch_size), "--warmup",
           str(warmup), "--iters", str(iters), "--sync", str(sync),
           "--device", device, "--model-axis", str(model_axis)]
    if backend:
        cmd += ["--backend", backend]
    procs = []
    for r in range(nproc):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE=str(nproc), LOCAL_RANK=str(r),
                   PYTHONPATH=os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(cmd, env=env, cwd=root,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("DP_RANK ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"rank {r} failed (exit {p.returncode}):\n"
                               f"{out[-4000:]}")
        ranks.append(json.loads(lines[-1][len("DP_RANK "):]))
    ms = max(r["ms_per_step"] for r in ranks)
    flops = sum(r["flops_per_step"] for r in ranks)
    rate = {"resnet50": "imgs_per_sec", "lm": "tokens_per_sec"}.get(
        model, "records_per_sec")
    per_step = batch_size * ranks[0]["seq"] if model == "lm" else batch_size
    return {"model": model, "nproc": nproc, "backend": backend or (
                "nccl" if device == "cuda" else "gloo"),
            "batch_size": batch_size, "model_axis": model_axis,
            "ms_per_step": ms, rate: per_step / ms * 1e3,
            "flops_per_step": flops,
            "mfu": costs.mfu(flops, ms * 1e-3, device_kind=ranks[0]["device"],
                             n_devices=nproc),
            "losses": [float(np.mean(v)) for v in
                       zip(*(r["losses"] for r in ranks))],
            "ranks": ranks}


#: the zoo's benchmark configurations: (builder, input shape, classes,
#: batch size); the builders live in `bigdl_tpu_torch.models`
ZOO = {
    "lenet": ("LeNet5", (28, 28), 10, 512),
    "inception_v1": ("Inception_v1_NoAuxClassifier", (224, 224, 3), 1000,
                     64),
    "inception_v2": ("Inception_v2_NoAuxClassifier", (224, 224, 3), 1000,
                     32),
    "vgg16": ("Vgg_16", (224, 224, 3), 1000, 32),
}


def zoo_model(name: str, device=None,
              generator: Optional[torch.Generator] = None
              ) -> torch.nn.Module:
    """The zoo model of the configuration `name`, random weights from
    `generator` (default seed 0), on `device`."""
    from bigdl_tpu_torch import models
    builder, _, n_class, _ = ZOO[name]
    kw = {"s2d_stem": True} if name == "inception_v1" else {}
    return getattr(models, builder)(n_class, **kw, device=device,
                                    generator=generator)


def bench_zoo(name: str, batch_size: Optional[int] = None, warmup: int = 8,
              iters: int = 40, sync: int = 8, device=None,
              generator: Optional[torch.Generator] = None) -> Dict:
    """`framework_throughput` of the zoo configuration `name` (`ZOO`), at
    its batch size unless `batch_size` is given; 8 + 40 steps, syncing
    every 8, as `bench_cli.py`'s baseline configurations run."""
    device = resolve_device(device)
    _, in_shape, n_class, default_batch = ZOO[name]
    res = framework_throughput(zoo_model(name, device, generator), in_shape,
                               n_class, batch_size or default_batch, warmup,
                               iters, sync=sync, device=device)
    return {"model": name, **res}


def _lm(vocab: int, device, generator=None):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(vocab, embed_dim=512, n_layer=4, n_head=8,
                         device=device, generator=generator)


def bench_transformer_lm(batch_size: int = 8, seq: int = 2048,
                         vocab: int = 1024, warmup: int = 12,
                         iters: int = 36, sync: int = 12, device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict:
    """`TransformerLM(vocab, embed 512, 4 layers, 8 heads)`, random weights
    from `generator` (default seed 0), trained as `bench_cli.py`'s LM block
    does (48 steps, sync every 12, timed after the first window)."""
    device = resolve_device(device)
    return lm_throughput(_lm(vocab, device, generator), vocab, seq,
                         batch_size, warmup, iters, sync=sync, device=device)


#: the PTB-LSTM configuration of `bench_cli.py`'s baseline configurations
#: (`BASELINE.md` config 4): vocabulary, hidden width, batch, time steps
PTB = {"vocab": 10001, "hidden": 200, "batch_size": 64, "seq": 20}


def _ptb_batch(vocab: int, seq: int, batch_size: int):
    """Seeded 1-based ids in [1, vocab) for the inputs and the targets,
    [B, T] int32 each, from `RandomState(0)`."""
    rs = np.random.RandomState(0)
    x = rs.randint(1, vocab, (batch_size, seq)).astype(np.int32)
    y = rs.randint(1, vocab, (batch_size, seq)).astype(np.int32)
    return x, y


def bench_ptb_lstm(batch_size: int = 64, seq: int = 20, vocab: int = 10001,
                   hidden: int = 200, warmup: int = 8, iters: int = 40,
                   sync: int = 8, device=None,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """`PTBModel(vocab, hidden, vocab)` (2 LSTM layers), random weights
    from `generator` (default seed 0), trained through
    `framework_throughput` on one resident batch of seeded ids under
    `TimeDistributedCriterion(ClassNLLCriterion())` (the loss summed over
    the T steps), as `bench_cli.py`'s baseline configurations run it (8 +
    40 steps, sync every 8). Reports records/s (sequences, the
    reference's unit), tokens/s, ms/step, the FLOP count and mfu."""
    from bigdl_tpu_torch.models.rnn import PTBModel
    device = resolve_device(device)
    model = PTBModel(vocab, hidden, vocab, device=device,
                     generator=generator)
    res = framework_throughput(
        model, (seq,), vocab, batch_size, warmup, iters, sync=sync,
        device=device, batch=_ptb_batch(vocab, seq, batch_size),
        criterion=TimeDistributedCriterion(ClassNLLCriterion()))
    records = res.pop("imgs_per_sec")
    return {"model": "ptb_lstm", "records_per_sec": records,
            "tokens_per_sec": records * seq, "seq": seq, "vocab": vocab,
            "hidden": hidden, **res}


def profile_ptb_lstm(batch_size: int = 64, seq: int = 20,
                     vocab: int = 10001, hidden: int = 200, warmup: int = 8,
                     steps: int = 8, top: int = 15, device=None,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """`_profile` of the PTB-LSTM benchmark configuration."""
    from bigdl_tpu_torch.models.rnn import PTBModel
    device = _cuda_only(device, "profile_ptb_lstm")
    model = PTBModel(vocab, hidden, vocab, device=device,
                     generator=generator)
    opt = _resident_optimizer(model, *_ptb_batch(vocab, seq, batch_size),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              device)
    return {"model": "ptb_lstm", "batch_size": batch_size, "seq": seq,
            **_profile(opt, warmup, steps, top, device)}


#: `BASELINE.md` config 5, Wide&Deep as `bench_cli.py:1645-1656` builds it
WIDE_N_DEEP = {"class_num": 2, "wide_dim": 100, "embed_vocabs": (10, 10),
               "embed_dim": 4, "cont_dim": 3, "batch_size": 1024}


def wide_n_deep_model(device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.nn.Module:
    """`WideAndDeep(2, wide_dim=100, embed_vocabs=(10, 10), embed_dim=4,
    cont_dim=3)`, random weights from `generator` (default seed 0)."""
    from bigdl_tpu_torch.models.widedeep import WideAndDeep
    cfg = {k: v for k, v in WIDE_N_DEEP.items() if k != "batch_size"}
    return WideAndDeep(**cfg, device=device, generator=generator)


def _wide_n_deep_batch(batch_size: int, seed: int = 0):
    """The four-tensor batch of config 5 from `RandomState(seed)`: wide
    ids [B, 3] in [0, 100) (0-based), wide values of 1, categorical ids
    [B, 2] in [1, 10), continuous features [B, 3] in [0, 1); labels 1 or
    2."""
    rs = np.random.RandomState(seed)
    b = batch_size
    x = [rs.randint(0, WIDE_N_DEEP["wide_dim"], (b, 3)).astype(np.int32),
         np.ones((b, 3), np.float32),
         rs.randint(1, 10, (b, 2)).astype(np.int32),
         rs.rand(b, 3).astype(np.float32)]
    y = (rs.randint(0, 2, b) + 1).astype(np.int32)
    return x, y


def bench_wide_n_deep(batch_size: int = 1024, warmup: int = 8,
                      iters: int = 40, sync: int = 8, device=None,
                      generator: Optional[torch.Generator] = None) -> Dict:
    """Config 5 trained through `framework_throughput` on one resident
    four-tensor batch (the model takes their `Table`) under
    `ClassNLLCriterion`, as `bench_cli.py`'s baseline configurations run
    it (8 + 40 steps, sync every 8). Reports records/s, ms/step, the FLOP
    count and mfu."""
    device = resolve_device(device)
    res = framework_throughput(
        wide_n_deep_model(device, generator), (), 2, batch_size, warmup,
        iters, sync=sync, device=device,
        batch=_wide_n_deep_batch(batch_size))
    return {"model": "wide_n_deep",
            "records_per_sec": res.pop("imgs_per_sec"), **res}


def profile_wide_n_deep(batch_size: int = 1024, warmup: int = 8,
                        steps: int = 8, top: int = 15, device=None,
                        generator: Optional[torch.Generator] = None) -> Dict:
    """`_profile` of the Wide&Deep benchmark configuration."""
    device = _cuda_only(device, "profile_wide_n_deep")
    opt = _resident_optimizer(wide_n_deep_model(device, generator),
                              *_wide_n_deep_batch(batch_size),
                              ClassNLLCriterion(), device)
    return {"model": "wide_n_deep", "batch_size": batch_size,
            **_profile(opt, warmup, steps, top, device, _WIDE_KINDS)}


def _kernel_launches() -> Dict[str, int]:
    """The launches of every kernel of the port so far, by name."""
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    from bigdl_tpu_torch.ops import stem_kernel as sk
    fns = {"flash_attention_fwd": ak.flash_attention_forward,
           "flash_attention_carry": ak.flash_attention_carry,
           "flash_attention_bwd_dq": ak.flash_attention_backward_dq,
           "flash_attention_bwd_dkv": ak.flash_attention_backward_dkv,
           "stem_conv": sk.stem_conv_forward,
           "bn_relu_fwd": bk.bn_relu_forward,
           "bn_relu_bwd": bk.bn_relu_backward}
    return {name: fn.launches for name, fn in fns.items()}


def wide_n_deep_rank(batch_size: int = 1024, warmup: int = 8,
                     iters: int = 16, sync: int = 8, device=None,
                     seed: int = 0) -> Dict:
    """This rank's part of the data-parallel Wide&Deep benchmark, in a
    process that has joined the process group: the global batch
    `batch_size` (seeded as `bench_wide_n_deep`'s) split over the ranks,
    this rank's rows of each of the four tensors and the labels resident
    on `device`; `_rank_run`'s figures (no kernel of the port launches on
    this path)."""
    _, _, local, rows = _rank_shard(batch_size)
    device = resolve_device(device)
    x, y = _wide_n_deep_batch(batch_size)
    opt = _resident_optimizer(
        wide_n_deep_model(device, torch.Generator().manual_seed(seed)),
        [v[rows] for v in x], y[rows], ClassNLLCriterion(), device)
    return _rank_run(opt, local, warmup, iters, sync)


def _median_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of one call of `fn` over `reps` calls after one
    warm-up: CUDA events around each call on a CUDA device, the host clock
    elsewhere."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _sp_mesh(device: torch.device, length: int):
    """The sequence-parallel mesh of the attention figures: every CUDA
    device when there are two or more, else 4 shards on `device`; and the
    sequence length, `length` rounded down to a multiple of 2n."""
    from bigdl_tpu_torch.parallel import build_mesh
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = ([torch.device("cuda", i) for i in range(n_dev)]
               if n_dev >= 2 else [device] * 4)
    n = len(devices)
    return build_mesh(data=n, devices=devices), {
        "seq": max(1, length // (2 * n)) * 2 * n, "shards": n,
        "mesh": [str(x) for x in devices], "one_device": n_dev < 2}


def _on_meta_mesh(mesh, scheme: str, fn):
    """`fn` (a sequence-parallel attention over `mesh`) for real inputs,
    and the same scheme over as many meta shards for meta inputs (the
    FLOP count)."""
    from bigdl_tpu_torch.parallel import (build_mesh,
                                          make_sequence_parallel_attention)
    n = len(mesh.devices.ravel())
    meta = make_sequence_parallel_attention(
        build_mesh(data=n, devices=["meta"] * n), scheme, causal=True)
    return lambda q, k, v: (meta if q.device.type == "meta" else fn)(q, k,
                                                                     v)


def bench_attention(device=None, lengths: Sequence[int] = (8192, 16384),
                    naive_max: int = 8192, ring_len: int = 8192,
                    reps: int = 10,
                    generator: Optional[torch.Generator] = None) -> Dict:
    """The long-context attention figures of `bench_cli.py`'s
    `bench_attention` (its LM block is `--model lm` here), at B=1, H=8,
    D=64, bf16, causal: the flash forward (kernel 1) and forward plus
    backward (kernels 1, 3, 4; gradients for q, k and v) at each of
    `lengths`, naive attention at lengths up to `naive_max`, and ring
    against zigzag sequence parallelism (kernel 2) at
    `ring_len // 2n * 2n` over a mesh of every CUDA device when there are
    two or more, else of 4 shards on the one device. Each call's `flops`
    is `costs.count_flops` of it: the kernels' counts, 2*D a product per
    unmasked pair (2 products forward, 3 + 4 more in the backward's dq
    and dk/dv kernels), and naive attention's own matmuls, masked pairs
    included; TFLOP/s and `mfu` divide it by the call's time."""
    from bigdl_tpu_torch.ops.attention_kernel import (flash_attention,
                                                      flash_attention_forward,
                                                      naive_attention)
    from bigdl_tpu_torch.parallel import make_sequence_parallel_attention
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    b, h, d, dtype = 1, 8, 64, torch.bfloat16

    def qkv(t):
        return [torch.randn((b, h, t, d), generator=gen).to(device, dtype)
                for _ in range(3)]

    def figures(fn, args, reps_, **extra):
        """ms, flops, TFLOP/s and mfu of one call `fn(*args)`, the count
        taken on meta copies of the arguments."""
        fl = costs.count_flops(fn, *[a.to("meta") for a in args])
        ms = _median_ms(lambda: fn(*args), reps_, device)
        return {**extra, "ms": ms, "flops": fl,
                "tflops": fl / (ms * 1e-3) / 1e12,
                "mfu": _mfu(fl, ms, device)}

    out = {"batch": b, "heads": h, "head_dim": d, "dtype": "bfloat16",
           "causal": True, "reps": reps, "device": _device_name(device),
           "timer": "cuda_events" if device.type == "cuda"
           else "host_clock", "flash": [], "flash_fwd_bwd": [], "naive": []}
    for t in lengths:
        q, k, v = qkv(t)
        with torch.no_grad():
            fwd = figures(lambda *a: flash_attention_forward(
                *a, causal=True), (q, k, v), reps, seq=t)
        out["flash"].append(fwd)

        def fwd_bwd(*a):
            a = [x.detach().requires_grad_() for x in a]
            return torch.autograd.grad(
                flash_attention(*a, True).float().sum(), a)

        out["flash_fwd_bwd"].append(figures(fwd_bwd, (q, k, v), reps,
                                            seq=t))
        if t <= naive_max:
            with torch.no_grad():
                naive = figures(lambda *a: naive_attention(
                    *a, causal=True), (q, k, v), reps, seq=t)
            naive["flash_speedup"] = naive["ms"] / fwd["ms"]
            out["naive"].append(naive)

    mesh, sp = _sp_mesh(device, ring_len)
    q, k, v = qkv(sp["seq"])
    for scheme in ("ring", "zigzag"):
        fn = make_sequence_parallel_attention(mesh, scheme, causal=True)
        with torch.no_grad():
            sp[scheme] = figures(_on_meta_mesh(mesh, scheme, fn),
                                 (q, k, v), reps)
    out["sequence_parallel"] = sp
    return out


#: kernel-name fragments of each kind in the profiles, tried in order
_KERNEL_KINDS = (
    ("flash_attention_fwd (csrc, kernel 1)",
     ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("flash_attention_carry (csrc, kernel 2)",
     ("flash_carry_kernel", "flash_carry_tc_kernel")),
    ("flash_attention_bwd_dq (csrc, kernel 3)",
     ("flash_attention_bwd_dq",)),
    ("flash_attention_bwd_dkv (csrc, kernel 4)",
     ("flash_attention_bwd_dkv",)),
    ("bn_relu (csrc)", ("bn_relu_fwd", "bn_relu_bwd")),
    ("stem_conv (csrc, kernel 5)", ("stem_conv_kernel",
                                    "stem_conv_tc_kernel")),
    ("convolution and matmul (cuDNN, cuBLAS)",
     ("conv", "xmma", "gemm", "nvjet", "cudnn", "cutlass", "dgrad", "wgrad",
      "fprop")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


#: the zoo's profiles also file `torch.cat` and `copy_` (the Concat
#: gradient slices made contiguous, the bf16 casts) on their own
_ZOO_KINDS = (("concat (torch.cat)", ("catarraybatchedcopy",)),
              ("copies and casts (copy_)", ("direct_copy",))) + _KERNEL_KINDS


#: the Wide&Deep profile also files the gathers and their gradients'
#: scatters on their own
_WIDE_KINDS = (("gather and scatter (embedding, index_add)",
                ("indexselect", "index_select", "embedding", "indexfunc",
                 "index_add", "gather", "scatter")),) + _KERNEL_KINDS


def _kind(name: str, kinds=_KERNEL_KINDS) -> str:
    low = name.lower()
    for kind, parts in kinds:
        if any(p in low for p in parts):
            return kind
    return "other"


def _profile(opt: DistriOptimizer, warmup: int, steps: int, top: int,
             device: torch.device, kinds=_KERNEL_KINDS) -> Dict:
    """Where the device time of `opt`'s training goes: after `warmup`
    steps, `steps` more under `torch.profiler`. Returns the device-busy
    and idle shares of the profiled wall time (host clock, from a drained
    device to a drained device), device ms per step by kind of kernel, and
    the `top` kernels by device time."""
    opt.set_sync_interval(warmup)
    opt.set_end_when(max_iteration(warmup))
    with _bench_telemetry(opt):
        opt.optimize()
        torch.cuda.synchronize(device)
        opt.set_sync_interval(steps)
        opt.set_end_when(max_iteration(warmup + steps))
        return _profiled(opt.optimize, steps, top, device, kinds)


# spin kernels launched at the start of each profiler window and left out
# of its counts and times: on an H100, some minutes into a process that
# profiles, every other window loses its first 9-12 device records
PROFILE_MARKERS = 64
# idle host time after the markers and at the window's end: a device
# timestamp has read up to 0.33 ms earlier than the host's clock, and the
# profiler keeps only the device events inside its window
PROFILE_MARGIN_S = 0.01


def open_profile_window(device=None) -> None:
    """Call first inside a `torch.profiler.profile` block: launch
    PROFILE_MARKERS spin kernels on the current stream, drain the device,
    idle PROFILE_MARGIN_S."""
    for _ in range(PROFILE_MARKERS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(device)
    time.sleep(PROFILE_MARGIN_S)


def close_profile_window(device=None) -> None:
    """Call last inside the block: drain the device, idle
    PROFILE_MARGIN_S."""
    torch.cuda.synchronize(device)
    time.sleep(PROFILE_MARGIN_S)


def is_profile_marker(name: str) -> bool:
    """Whether a device event's name is `open_profile_window`'s kernel."""
    return "spin_kernel" in name


def _launching_op(evt) -> str:
    """The op a device kernel was launched from, for `evt`, the profiler's
    CPU event that launched it: the autograd node it ran under in a
    backward (`VarBackward0`, ...), else the outermost aten op
    (`aten::var`, ...)."""
    name, e = evt.name, evt
    while e is not None:
        if e.name.startswith("autograd::engine::evaluate_function: "):
            return e.name.split(": ", 1)[1]
        if e.name.startswith("aten::"):
            name = e.name
        e = e.cpu_parent
    return name


def _profiled(run, steps: int, top: int, device: torch.device,
              kinds=_KERNEL_KINDS) -> Dict:
    """Run `run()` (`steps` steps, the device drained before) under
    `torch.profiler` and summarise where its device time goes, also by
    the op that launched each kernel (`_launching_op`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_profile_window(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        close_profile_window(device)
    by_name: Dict[str, list] = {}
    by_op: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            op = _launching_op(e)
            by_op[op] = by_op.get(op, 0.0) + sum(
                k.duration for k in e.kernels
                if not is_profile_marker(k.name)) / 1e3 / steps
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or is_profile_marker(e.name)):
            continue
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us() / 1e3
    if not by_name:
        raise RuntimeError("the profiler recorded no device events")
    busy_ms = sum(ms for _, ms in by_name.values())
    by_kind: Dict[str, float] = {}
    for name, (_, ms) in by_name.items():
        kind = _kind(name, kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches_per_step": sum(
                n for n, _ in by_name.values()) / steps,
            "ms_per_step_by_kind": dict(sorted(by_kind.items(),
                                               key=lambda kv: -kv[1])),
            "top_kernels": [{"name": name[:120], "kind": _kind(name, kinds),
                             "calls_per_step": n / steps,
                             "ms_per_step": ms / steps}
                            for name, (n, ms) in ranked],
            "ms_per_step_by_op": dict(sorted(
                by_op.items(), key=lambda kv: -kv[1])[:max(top, 25)]),
            "device": torch.cuda.get_device_name(device)}


def _cuda_only(device, what: str) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} measures the CUDA device")
    return device


def profile_resnet50(batch_size: int = 128, warmup: int = 8, steps: int = 8,
                     top: int = 15, device=None,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """`_profile` of the ResNet-50 benchmark configuration."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    device = _cuda_only(device, "profile_resnet50")
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    opt = _resident_optimizer(model, *_image_batch((224, 224, 3), 1000,
                                                   batch_size),
                              ClassNLLCriterion(), device)
    return {"batch_size": batch_size,
            **_profile(opt, warmup, steps, top, device)}


def _lrn_ms(shapes, device: torch.device, reps: int = 10) -> float:
    """Device ms of one forward and backward of
    `SpatialCrossMapLRN(5, 1e-4, 0.75)` in bf16 at each of `shapes`,
    summed (CUDA events)."""
    from bigdl_tpu_torch.nn import SpatialCrossMapLRN
    lrn = SpatialCrossMapLRN(5, 0.0001, 0.75)
    total = 0.0
    for shape in shapes:
        x = torch.rand(shape, device=device, dtype=torch.bfloat16)
        x.requires_grad_()
        g = torch.ones(shape, device=device, dtype=torch.bfloat16)
        total += _median_ms(lambda: torch.autograd.grad(lrn(x), x, g),
                            reps, device)
    return total


def profile_zoo(name: str, batch_size: Optional[int] = None,
                warmup: int = 8, steps: int = 8, top: int = 15, device=None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """`_profile` of the zoo configuration `name` (`ZOO`), with
    `torch.cat` and `copy_` filed on their own; also the BN+ReLU
    gradient copies a step (`BnReluFunction.g_copies`) and the device ms
    a step of the model's LRN layers, each timed alone at the shape it
    saw (forward and backward)."""
    from bigdl_tpu_torch.nn import SpatialCrossMapLRN
    from bigdl_tpu_torch.ops.bn_relu_kernel import BnReluFunction
    device = _cuda_only(device, "profile_zoo")
    _, in_shape, n_class, default_batch = ZOO[name]
    batch_size = batch_size or default_batch
    model = zoo_model(name, device, generator)
    lrn_shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args: lrn_shapes.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, SpatialCrossMapLRN)]
    opt = _resident_optimizer(model, *_image_batch(in_shape, n_class,
                                                   batch_size),
                              ClassNLLCriterion(), device)
    copies = BnReluFunction.g_copies
    out = _profile(opt, warmup, steps, top, device, _ZOO_KINDS)
    for h in hooks:
        h.remove()
    lrn_shapes = lrn_shapes[:len(hooks)]  # one step's
    return {"model": name, "batch_size": batch_size,
            "bn_relu_g_copies_per_step":
                (BnReluFunction.g_copies - copies) / (warmup + steps),
            "lrn_shapes": lrn_shapes,
            "lrn_ms_per_step": _lrn_ms(lrn_shapes, device), **out}


def _served_resnet50(batch_size: int, device: torch.device,
                     generator: Optional[torch.Generator]):
    """The served configuration: `ResNet50(class_num=1000, s2d_stem=True)`
    through a `LocalPredictor` (the converted copy: 52 BNs folded, the
    stem's kept), and one b`batch_size` image batch on `device`."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    from bigdl_tpu_torch.optim.predictor import LocalPredictor
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    pred = LocalPredictor(model, batch_size=batch_size, device=device)
    x, _ = _image_batch((224, 224, 3), 1000, batch_size)
    return pred, torch.from_numpy(x).to(device)


@contextlib.contextmanager
def _serving_settings(stem_kernel: bool):
    """f32 convolutions without TF32, and the stem switch set or unset,
    for the block; both restored after."""
    saved = (os.environ.pop(STEM_ENV, None), torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    if stem_kernel:
        os.environ[STEM_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(STEM_ENV, None)
        if saved[0] is not None:
            os.environ[STEM_ENV] = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def bench_resnet50_serving(batch_size: int = 32, reps: int = 20,
                           device=None,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """Median ms of one forward of the served ResNet-50 (f32, TF32 off)
    with the stem switch unset (cuDNN stem) and set (the stem kernel), the
    forward's FLOP count (the same either way: kernel 5 counts the 7x7
    convolution it restates) and each one's mfu."""
    device = resolve_device(device)
    pred, x = _served_resnet50(batch_size, device, generator)
    out = {"batch_size": batch_size, "reps": reps,
           "device": _device_name(device),
           "timer": "cuda_events" if device.type == "cuda"
           else "host_clock"}
    twin = copy.copy(pred)
    twin.model = _meta(pred.model)
    with _serving_settings(True):
        flops = out["flops_per_forward"] = costs.count_flops(
            twin._forward, x.to("meta"))
    for label, on in (("cudnn_stem", False), ("stem_kernel", True)):
        with _serving_settings(on):
            ms = out[f"{label}_ms"] = _median_ms(lambda: pred._forward(x),
                                                 reps, device)
        out[f"{label}_mfu"] = _mfu(flops, ms, device)
    return out


def profile_resnet50_serving(batch_size: int = 32, forwards: int = 8,
                             top: int = 15, device=None,
                             generator: Optional[torch.Generator] = None
                             ) -> Dict:
    """`_profiled` of the served ResNet-50 with the stem kernel on (f32,
    TF32 off): `forwards` forwards after one warm-up; a "step" in the
    summary is one forward."""
    device = _cuda_only(device, "profile_resnet50_serving")
    pred, x = _served_resnet50(batch_size, device, generator)
    with _serving_settings(True):
        pred._forward(x)
        torch.cuda.synchronize(device)
        return {"batch_size": batch_size, **_profiled(
            lambda: [pred._forward(x) for _ in range(forwards)], forwards,
            top, device)}


def profile_transformer_lm(batch_size: int = 8, seq: int = 2048,
                           vocab: int = 1024, warmup: int = 4,
                           steps: int = 4, top: int = 15, device=None,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """`_profile` of the TransformerLM benchmark configuration."""
    device = _cuda_only(device, "profile_transformer_lm")
    opt = _resident_optimizer(_lm(vocab, device, generator),
                              *_token_batch(vocab, seq, batch_size),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              device)
    return {"batch_size": batch_size, "seq": seq,
            **_profile(opt, warmup, steps, top, device)}


def _launch_us(run, part: str, device: torch.device) -> list:
    """Device time (us) of each launch of the kernels whose name contains
    `part` during one `run()`, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_profile_window(device)
        run()
        close_profile_window(device)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and part in e.name),
                    key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in events]


def profile_attention(seq: int = 8192, calls: int = 4, top: int = 8,
                      device=None,
                      generator: Optional[torch.Generator] = None) -> Dict:
    """`_profiled` of ring, zigzag and Ulysses attention at
    `bench_attention`'s sequence-parallel shape (B=1, H=8, D=64, bf16,
    causal, its mesh): `calls` calls of each after one warm-up call; a
    "step" in the summary is one call. For ring and zigzag also the
    device time of each kernel-2 launch (one hop) of one more call, in
    launch order."""
    from bigdl_tpu_torch.parallel import make_sequence_parallel_attention
    device = _cuda_only(device, "profile_attention")
    gen = generator or torch.Generator().manual_seed(0)
    mesh, out = _sp_mesh(device, seq)
    q, k, v = (torch.randn((1, 8, out["seq"], 64), generator=gen)
               .to(device, torch.bfloat16) for _ in range(3))
    for scheme in ("ring", "zigzag", "ulysses"):
        fn = make_sequence_parallel_attention(mesh, scheme, causal=True)
        with torch.no_grad():
            fn(q, k, v)
            torch.cuda.synchronize(device)
            out[scheme] = _profiled(
                lambda: [fn(q, k, v) for _ in range(calls)], calls, top,
                device)
            if scheme != "ulysses":
                out[scheme]["kernel2_launch_us"] = _launch_us(
                    lambda: fn(q, k, v), "flash_carry", device)
    return out


def _chaos_mlp(device: torch.device) -> torch.nn.Module:
    """The drills' MNIST-shaped MLP: 784 -> 128 -> tanh -> 10."""
    from bigdl_tpu_torch import nn
    return (nn.Sequential().add(nn.Reshape([784]))
            .add(nn.Linear(784, 128, device=device)).add(nn.Tanh())
            .add(nn.Linear(128, 10, device=device)).add(nn.LogSoftMax()))


def bench_chaos(crash_at: int = 8, iters: int = 16, ckpt_every: int = 4,
                batch_size: int = 64, n_samples: int = 1024,
                keep_last_n: int = 3, device=None) -> Dict:
    """The job-level crash drill (`--chaos`): an MNIST-shaped MLP through
    the `Optimizer` factory's `DistriOptimizer` with a checkpoint every
    `ckpt_every` steps, a transient `train.step` fault at step
    `crash_at`, and the retry policy's backoff and reload. MTTR is read
    off the telemetry stream: from the `fault_injected` event to the first
    `step` record after it. Prints and returns one JSON object: MTTR,
    retries, backoff, the steps trained again (`lost_iterations`) and the
    final step."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.optim import Optimizer, several_iteration
    from bigdl_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                            RetryPolicy)
    device = resolve_device(device)
    rs = np.random.RandomState(0)
    X = rs.rand(n_samples, 28, 28).astype(np.float32)
    Y = (rs.randint(0, 10, n_samples) + 1).astype(np.int32)
    sink = InMemorySink()
    telemetry = Telemetry(sink, resources=False, flight=False)
    ckpt_dir = tempfile.mkdtemp(prefix="bigdl_tpu_torch_chaos_")
    opt = Optimizer(_chaos_mlp(device), (X, Y), ClassNLLCriterion(),
                    batch_size=batch_size, local=False, device=device,
                    retry_policy=RetryPolicy(max_retries=3,
                                             base_delay_s=0.05, seed=0,
                                             name="chaos"))
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(max_iteration(iters))
    opt.set_checkpoint(ckpt_dir, several_iteration(ckpt_every),
                       keep_last_n=keep_last_n)
    opt.set_telemetry(telemetry)
    try:
        with FaultInjector(FaultSpec("train.step", at_hit=crash_at),
                           telemetry=telemetry):
            opt.optimize()
    finally:
        telemetry.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_fault = next((r["time"] for r in sink.records
                    if r.get("event") == "fault_injected"), None)
    post = [r for r in sink.records if r.get("type") == "step"
            and t_fault is not None and r["time"] > t_fault]
    retries = [r for r in sink.records if r.get("event") == "retry"]
    final_step = int(opt.optim_method.state.get("neval", 0))
    out = {
        "metric": "chaos_mttr",
        "fault_site": "train.step",
        "crash_at_iteration": crash_at,
        "recovered": bool(post) and final_step >= iters,
        "mttr_s": round(post[0]["time"] - t_fault, 4) if post else None,
        "retries": len(retries),
        "backoff_s": round(sum(r.get("delay_s", 0.0) for r in retries), 4),
        "lost_iterations": (crash_at - 1) - min(
            (int(r["step"]) for r in post), default=crash_at) + 1
        if post else None,
        "final_step": final_step,
        "checkpoint_every": ckpt_every,
        "device": _device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


def bench_chaos_device_loss(lose_at: int = 5, rejoin_at: int = 12,
                            iters: int = 18, batch_size: int = 64,
                            n_samples: int = 512, sync: int = 2,
                            device=None) -> Dict:
    """The elastic drill (`--device-loss`): the MLP through
    `DistriOptimizer.set_elastic` over a 2-worker `SimulatedCluster` on
    two slots of `device`, with gradient bucketing set (in elastic mode
    the setter only reports the plan). Worker1 is
    lost at step `lose_at` (`mesh.device_loss`); the loop shrinks to the
    survivor, rolls back to the committed boundary, replays, and trains on
    degraded; at step `rejoin_at` worker1 heartbeats back and the loop
    grows at the next committed boundary. MTTR: from the `worker_lost`
    event to the first `step` record after it; the degraded throughput:
    step records inside the shrink..grow window against the others.
    Prints and returns one JSON object."""
    from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.parallel import build_mesh
    from bigdl_tpu_torch.resilience import (DeviceLossError, FaultInjector,
                                            FaultSpec, SimulatedCluster)
    device = resolve_device(device)
    rs = np.random.RandomState(0)
    samples = [Sample(rs.rand(28, 28).astype(np.float32),
                      np.int32(rs.randint(0, 10) + 1))
               for _ in range(n_samples)]
    sink = InMemorySink()
    telemetry = Telemetry(sink, resources=False, flight=False)
    cluster = SimulatedCluster(2, devices=[device] * 2, telemetry=telemetry)
    ds = LocalDataSet(samples).transform(
        SampleToMiniBatch(batch_size, drop_remainder=True))
    opt = DistriOptimizer(_chaos_mlp(device), ds, ClassNLLCriterion(),
                          build_mesh(data=2, devices=[device] * 2),
                          retry_times=0)
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(max_iteration(iters))
    opt.set_sync_interval(sync)
    opt.set_elastic(registry=cluster.registry)
    opt.set_gradient_bucketing()
    opt.set_telemetry(telemetry)
    opt.set_iteration_hook(
        lambda s: cluster.restore("worker1")
        if s["neval"] == rejoin_at else None)
    try:
        with FaultInjector(FaultSpec(
                "mesh.device_loss", at_hit=lose_at,
                exc=lambda ctx: DeviceLossError("injected preemption",
                                                lost=("worker1",))),
                telemetry=telemetry):
            opt.optimize()
    finally:
        telemetry.close()
    t_lost = next((r["time"] for r in sink.records
                   if r.get("event") == "worker_lost"), None)
    t_grow = next((r["time"] for r in sink.records
                   if r.get("event") == "elastic_grow"), None)
    steps = [r for r in sink.records if r.get("type") == "step"]
    post = [r for r in steps if t_lost is not None and r["time"] > t_lost]
    degraded = [r for r in post if t_grow is None or r["time"] <= t_grow]
    healthy = [r for r in steps if r not in degraded]
    replays = [r for r in sink.records if r.get("event") == "elastic_replay"]

    def mean_tp(rows):
        vals = [r["throughput"] for r in rows
                if isinstance(r.get("throughput"), (int, float))]
        return float(np.mean(vals)) if vals else None

    tp_d, tp_h = mean_tp(degraded), mean_tp(healthy)
    final_step = int(opt.optim_method.state.get("neval", 0))
    out = {
        "metric": "chaos_device_loss",
        "fault_site": "mesh.device_loss",
        "lost_at_iteration": lose_at,
        "rejoin_at_iteration": rejoin_at,
        "recovered": bool(post) and final_step >= iters,
        "mttr_s": round(post[0]["time"] - t_lost, 4) if post else None,
        "replayed_batches": int(sum(r.get("batches", 0) for r in replays)),
        "grew_back": t_grow is not None,
        "degraded_throughput": round(tp_d, 1) if tp_d else None,
        "degraded_throughput_frac":
            round(tp_d / tp_h, 3) if tp_d and tp_h else None,
        "final_step": final_step,
        "device": _device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


def serve_fleet_drill(fleet, samples: Sequence, sink, clients: int = 6,
                      requests_per_client: int = 40, crash: bool = False,
                      deadline_ms: float = 15_000.0,
                      maintain_every_s: float = 0.005):
    """The reference's `bench_serve_fleet` drill over an open `fleet`
    (which the caller closes), whose telemetry feeds `sink` (an
    `InMemorySink`): `clients` closed-loop threads, each submitting its
    `requests_per_client` requests with session affinity (`client<k>`)
    in windows of 4 (sample `(k * 31 + i) % len(samples)`), while
    this thread ticks `fleet.maintain()` every `maintain_every_s`. With
    `crash`, a `serve.replica_crash` plan kills replica1 at its first
    tick after 25% and before 75% of the requests resolved.

    MTTR is read off the telemetry stream: from the `worker_lost` event
    to the first status-ok `trace` record after it; the degraded
    throughput is the ok records' rate in equal windows (<= 1 s) after
    over before the loss. Returns (the reference's keys plus the wall
    time, requests/s and the client-side latency p50/p99 of the ok
    requests, the ok rows as (sample index, row) pairs)."""
    import threading
    from concurrent.futures import TimeoutError as FuturesTimeoutError

    from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec
    from bigdl_tpu_torch.serving import (ServingReroutedError,
                                         ServingTimeoutError)
    counts = {"ok": 0, "timed_out": 0, "rerouted": 0, "other": 0}
    rows, latencies = [], []
    lock = threading.Lock()
    total = clients * requests_per_client

    def worker(k):
        # a window of requests in flight per client (not one blocking
        # predict at a time), so the fleet carries real queue depth and
        # the crash catches queued work
        futs = []

        def collect():
            for idx, t0, fut in futs:
                row = None
                try:
                    row = fut.result(timeout=60.0)
                    key = "ok"
                except ServingReroutedError:
                    key = "rerouted"
                except (FuturesTimeoutError, ServingTimeoutError):
                    key = "timed_out"
                except Exception as e:  # counted; the drill wants none
                    key = "other"
                    print(f"fleet request failed: {e!r}", file=sys.stderr)
                with lock:
                    counts[key] += 1
                    if row is not None:
                        rows.append((idx, row))
                        latencies.append(time.perf_counter() - t0)
            futs.clear()

        for i in range(requests_per_client):
            idx = (k * 31 + i) % len(samples)
            try:
                futs.append((idx, time.perf_counter(), fleet.submit(
                    samples[idx], deadline_ms=deadline_ms,
                    session=f"client{k}")))
            except Exception as e:  # counted; the drill wants none
                print(f"fleet submit failed: {e!r}", file=sys.stderr)
                with lock:
                    counts["other"] += 1
            if len(futs) >= 4:  # the reference's window
                collect()
        collect()

    def mid_traffic(ctx):
        # only while traffic is mid-flight: a crash before it proves
        # nothing, one after it leaves no stream to measure recovery on
        if ctx.get("replica") != "replica1":
            return False
        with lock:
            done = sum(counts.values())
        return total * 0.25 <= done < total * 0.75

    plan = FaultInjector(FaultSpec("serve.replica_crash", at_hit=1,
                                   when=mid_traffic),
                         telemetry=fleet.telemetry)
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    with plan if crash else contextlib.nullcontext():
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            fleet.maintain()
            time.sleep(maintain_every_s)
        for t in threads:
            t.join()
        fleet.maintain()
    wall = time.perf_counter() - t0

    counters = fleet.fleet_counters()
    resolved = sum(counts.values())
    t_lost = next((r["time"] for r in sink.records
                   if r.get("event") == "worker_lost"), None)
    ok_times = sorted(r["time"] for r in sink.records
                      if r.get("type") == "trace"
                      and r.get("status") == "ok")
    mttr = degraded = None
    if t_lost is not None and ok_times:
        post = [t for t in ok_times if t > t_lost]
        mttr = round(post[0] - t_lost, 4) if post else None
        w = min(1.0, t_lost - ok_times[0],
                (ok_times[-1] - t_lost) if post else 0.0)
        if w > 0:
            before = sum(1 for t in ok_times if t_lost - w <= t <= t_lost)
            after = sum(1 for t in ok_times if t_lost < t <= t_lost + w)
            if before:
                degraded = round(after / before, 3)
    lat = np.asarray(latencies) * 1e3
    out = {
        "metric": "serve_fleet",
        "replicas": counters["replicas_total"],
        "clients": clients,
        "requests": total,
        "chaos_replica_loss": crash,
        **counts,
        "reroutes": counters["reroutes_total"],
        "drains": counters["drains_total"],
        "mttr_s": mttr,
        "degraded_throughput_frac": degraded,
        "recovered": (resolved == total and counts["other"] == 0
                      and (not crash or mttr is not None)),
        "wall_s": wall,
        "requests_per_sec": resolved / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)) if lat.size
        else None,
        "latency_ms_p99": float(np.percentile(lat, 99)) if lat.size
        else None,
    }
    return out, rows


def bench_serve_fleet(replicas: int = 3, clients: int = 6,
                      requests_per_client: int = 40, crash: bool = False,
                      deadline_ms: float = 15_000.0,
                      maintain_every_s: float = 0.005, *, device=None,
                      image_hw: int = 224) -> Dict:
    """The serving-fleet drill (`--model serve_fleet [--crash]`, the
    reference's `bench_serve_fleet`) over the served ResNet-50 of `--model
    serve` (`ResNet50(class_num=1000, s2d_stem=True)`, f32, TF32 off, the
    stem switch set, so each replica's forward runs kernels 5 and 6): a
    `ServingFleet` of `replicas` `InferenceEngine`s (max batch 8,
    `max_wait_ms` 1, queue 256, reject on full; drain grace 0.5 s, lease
    30 s), warmed with the first of 32 seeded images, driven by
    `serve_fleet_drill`. The replicas share one device, so the figures are
    no scaling figures. With `$BIGDL_TPU_TELEMETRY` set to a stem the
    stream also goes to `STEM.jsonl`, which `metrics_cli slo --check
    --mttr-s 60 --latency-p99-ms DEADLINE_MS` replays as the gate of a
    chaos run, the latency ceiling at the requests' deadline as in the
    reference's replay drill (the default 100 ms is the ceiling of the
    reference's MLP fleet, which ResNet-50 misses). Prints and returns
    one JSON object: the reference's keys (outcome tallies, reroutes,
    drains, MTTR, degraded throughput, recovered) plus the wall time,
    requests/s, the client-side p50/p99 latency and the device."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.resnet import ResNet50
    from bigdl_tpu_torch.observability import (InMemorySink, JsonlSink,
                                               Telemetry)
    from bigdl_tpu_torch.serving import ServingFleet
    device = resolve_device(device)
    model = ResNet50(class_num=1000, s2d_stem=True, device=device)
    images = np.random.RandomState(0).rand(
        32, image_hw, image_hw, 3).astype(np.float32)
    samples = [Sample(x) for x in images]
    sink = InMemorySink()
    sinks = [sink]
    stem = os.environ.get(TELEMETRY_ENV)
    if stem:
        sinks.append(JsonlSink(stem + ".jsonl"))
    telemetry = Telemetry(*sinks, resources=False, flight=False)
    with _serving_settings(True):
        fleet = ServingFleet(
            model, n_replicas=replicas, warmup_sample=samples[0],
            telemetry=telemetry, drain_grace_s=0.5, lease_s=30.0,
            engine_kwargs={"max_batch_size": 8, "max_wait_ms": 1.0,
                           "queue_capacity": 256, "device": device})
        try:
            out, _ = serve_fleet_drill(fleet, samples, sink, clients,
                                       requests_per_client, crash,
                                       deadline_ms, maintain_every_s)
        finally:
            fleet.close()
            telemetry.close()
    out["device"] = _device_name(device)
    print(json.dumps(out), flush=True)
    return out


def _replay_mlp(device: torch.device) -> torch.nn.Module:
    """The reference's replay-drill MLP (784-32-10 over 28x28 samples),
    weights from seed 0."""
    import bigdl_tpu_torch.nn as nn
    g = torch.Generator().manual_seed(0)
    return (nn.Sequential().add(nn.Reshape([784]))
            .add(nn.Linear(784, 32, device=device, generator=g))
            .add(nn.Tanh())
            .add(nn.Linear(32, 10, device=device, generator=g))
            .add(nn.LogSoftMax()))


def replay_workload(make_fleet, workload, seed: int,
                    deadline_ms: float = 60_000.0,
                    stream: Optional[str] = None) -> Dict:
    """Replay `workload` once on a fresh fleet from `make_fleet(None)`
    (closed after) under a `VirtualClock`, with its chaos plan drawn at
    `seed` and an `SloEngine(default_slos(latency_p99_ms=deadline_ms))`
    on the replay's telemetry; with `stream` the canonical stream is also
    written there. Returns the seed, the wall time, requests/s, the
    latency p50/p99 of the canonical trace records (wall clock, which the
    diff ignores), the outcome tallies, `chaos_fired`, the stream path,
    the replayer's summary and the canonical records."""
    from bigdl_tpu_torch.observability import (InMemorySink, JsonlSink,
                                               Telemetry)
    from bigdl_tpu_torch.observability.slo import SloEngine, default_slos
    from bigdl_tpu_torch.workload import (ChaosSchedule, VirtualClock,
                                          WorkloadReplayer)
    sink = InMemorySink()
    sinks = [sink]
    if stream:
        sinks.append(JsonlSink(stream, append=False))
    tel = Telemetry(*sinks, resources=False, flight=False)
    SloEngine(default_slos(latency_p99_ms=deadline_ms),
              emit_every_s=0.25).attach(tel)
    target = make_fleet(None)
    t0 = time.perf_counter()
    try:
        summary = WorkloadReplayer(
            target, workload,
            chaos=ChaosSchedule.from_dicts(workload.chaos, seed=seed),
            seed=seed, telemetry=tel, clock=VirtualClock(),
            progress_every=max(1, len(workload) // 5)).run()
    finally:
        wall = time.perf_counter() - t0
        target.close()
        tel.close()
    lat = np.asarray([r["latency_ms"] for r in sink.records
                      if r["type"] == "trace" and "latency_ms" in r])
    return {"seed": seed, "wall_s": wall,
            "requests_per_sec": len(workload) / wall,
            "latency_ms_p50": float(np.percentile(lat, 50))
            if lat.size else None,
            "latency_ms_p99": float(np.percentile(lat, 99))
            if lat.size else None,
            "outcomes": {k: summary.get(k) for k in
                         ("ok", "errors", "timeouts", "shed")},
            "chaos_fired": summary.get("chaos_fired"),
            "stream": stream, "summary": summary,
            "records": sink.records}


def replay_invariance_drill(make_fleet, samples: Sequence, requests: int = 90,
                            sessions: int = 6, seed: int = 7,
                            deadline_ms: float = 60_000.0,
                            tel_dir: Optional[str] = None) -> Dict:
    """The reference's replay-invariance drill over fleets that
    `make_fleet(telemetry)` builds (a fresh `ServingFleet` each call, its
    engines reporting to `telemetry`, which may be None; the drill closes
    it): record `requests` live requests over `sessions` sessions
    (`idempotent=True`, `deadline_ms`; replica1 failed at request
    `requests // 3` and restored at `2 * requests // 3`) into a
    `WorkloadRecorder`, save the workload with the seeded chaos plan (kill
    after `requests // 3` entries, restore after `2 * requests // 3`,
    targets left to the schedule's rng) and load it back, then
    `replay_workload` it on fresh fleets: at `seed`, at `seed` again and
    at `seed + 1`. With `tel_dir` the three canonical streams go to
    `replay_invariance_{a,b,perturbed}_<pid>.jsonl` there and the
    workload file to `replay_workload_<pid>.jsonl` (else to a temporary
    directory, removed after). Returns the reference's keys, plus each
    replay's `replay_workload` result under its tag."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.observability import Telemetry
    from bigdl_tpu_torch.workload import (ChaosAction, Workload,
                                          WorkloadRecorder, compare_streams)
    if tel_dir:
        os.makedirs(tel_dir, exist_ok=True)
    wl_dir = tel_dir or tempfile.mkdtemp(prefix="replay_drill_")

    # record a live run, with a kill and restore mid-run (rerouting noise
    # the recorder distils away)
    recorder = WorkloadRecorder(name="ci_fleet_run", seed=seed)
    rec_tel = Telemetry(recorder, resources=False, flight=False)
    t0 = time.perf_counter()
    fleet = make_fleet(rec_tel)
    try:
        futs = []
        for i in range(requests):
            futs.append(fleet.submit(samples[i % len(samples)],
                                     deadline_ms=deadline_ms,
                                     session=f"s{i % sessions}",
                                     idempotent=True))
            if i == requests // 3:
                fleet.fail("replica1", reason="recorded chaos kill")
            elif i == (2 * requests) // 3:
                fleet.restore("replica1")
        for f in futs:
            try:
                f.result(timeout=60.0)
            except Exception:
                pass  # outcomes are the replay's to re-derive
    finally:
        fleet.close()
        rec_tel.close()
    record_s = time.perf_counter() - t0
    chaos_plan = [ChaosAction("kill", after_entries=requests // 3),
                  ChaosAction("restore", after_entries=(2 * requests) // 3)]
    workload = recorder.workload(chaos=[a.to_dict() for a in chaos_plan])
    wl_path = os.path.join(wl_dir, f"replay_workload_{os.getpid()}.jsonl")
    workload.save(wl_path)
    workload = Workload.load(wl_path)  # replay what a gate would replay

    replays = []
    try:
        for tag, replay_seed in (("a", seed), ("b", seed),
                                 ("perturbed", seed + 1)):
            stream = (os.path.join(
                tel_dir, f"replay_invariance_{tag}_{os.getpid()}.jsonl")
                if tel_dir else None)
            replays.append({"tag": tag, **replay_workload(
                make_fleet, workload, replay_seed, deadline_ms, stream)})
    finally:
        if not tel_dir:
            shutil.rmtree(wl_dir, ignore_errors=True)
    a, b, p = replays
    same = compare_streams(a["records"], b["records"])
    perturbed = compare_streams(a["records"], p["records"])
    return {
        "metric": "replay_invariance",
        "workload_entries": len(workload),
        "replicas": a["summary"].get("replicas"),
        "seed": seed,
        "chaos_fired": a["summary"].get("chaos_fired"),
        "outcomes": a["outcomes"],
        "invariant": not same.divergent,
        "invariance_break": same.first,
        "perturbation_detected": perturbed.divergent,
        "perturbation_pointer": perturbed.first,
        "streams": [r["stream"] for r in replays if r["stream"]],
        "workload_file": wl_path if tel_dir else None,
        "record_s": record_s,
        "replays": replays,
    }


def bench_replay_invariance(replicas: int = 3, requests: int = 90,
                            sessions: int = 6, seed: int = 7,
                            deadline_ms: float = 60_000.0, *,
                            model: str = "mlp", device=None) -> Dict:
    """The reference's replay-invariance drill (`--model
    replay_invariance`, the gate behind `metrics_cli diff`), run by
    `replay_invariance_drill` over fleets of `replicas` `InferenceEngine`s
    (max batch 8, `max_wait_ms` 1, queue 256, reject on full; drain grace
    0.5 s, lease 30 s, ring seed 0) serving `model`:

    - "mlp": the reference's MLP (784-32-10) on 16 seeded 28x28 samples;
    - "resnet50": the served ResNet-50 of `--model serve` (1000 classes,
      `s2d_stem=True`, seed 0, f32, TF32 off, `BIGDL_TPU_PALLAS_STEM` set:
      kernels 5 and 6 in every batch) on 16 seeded 224x224x3 images, its
      engines with breakers (5 failures, 30 s reset) as the serving
      fleet's drill has them.

    Every fleet serves the same weights. With `$BIGDL_TPU_TELEMETRY`
    naming a directory, the three canonical streams and the workload file
    land there, for `metrics_cli diff` and `metrics_cli slo --check`.
    Prints and returns ONE JSON object: the reference's keys (`invariant`
    and `perturbation_detected` must both hold) plus each replay's wall
    time, requests/s and latency p50/p99, the engines the drill built
    (its four fleets and their restores), their dispatched batches and
    warm-up buckets, and the device."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.serving import InferenceEngine, ServingFleet
    device = resolve_device(device)
    rs = np.random.RandomState(0)
    engine_kwargs = {"max_batch_size": 8, "max_wait_ms": 1.0,
                     "queue_capacity": 256, "admission": "reject",
                     "device": device}
    if model == "mlp":
        net = _replay_mlp(device)
        samples = [Sample(rs.rand(28, 28).astype(np.float32))
                   for _ in range(16)]
        settings = contextlib.nullcontext()
    elif model == "resnet50":
        from bigdl_tpu_torch.models.resnet import ResNet50
        net = ResNet50(class_num=1000, s2d_stem=True, device=device,
                       generator=torch.Generator().manual_seed(0))
        samples = [Sample(rs.rand(224, 224, 3).astype(np.float32))
                   for _ in range(16)]
        engine_kwargs["breaker"] = {"failure_threshold": 5,
                                    "reset_timeout_s": 30.0}
        settings = _serving_settings(True)
    else:
        raise ValueError(f"model must be 'mlp' or 'resnet50', got {model!r}")
    engines = []  # every engine of the four fleets, restores included

    def make_fleet(telemetry):
        def factory(rid):
            eng = InferenceEngine(net, telemetry=telemetry, replica_id=rid,
                                  **engine_kwargs)
            engines.append(eng)
            return eng
        return ServingFleet(engine_factory=factory, n_replicas=replicas,
                            warmup_sample=samples[0], telemetry=telemetry,
                            drain_grace_s=0.5, lease_s=30.0, seed=0)

    with settings:
        res = replay_invariance_drill(
            make_fleet, samples, requests, sessions, seed, deadline_ms,
            tel_dir=os.environ.get(TELEMETRY_ENV))
    out = {k: v for k, v in res.items() if k != "replays"}
    out.update({"model": model, "device": _device_name(device),
                "replays": [{k: r[k] for k in (
                    "tag", "seed", "wall_s", "requests_per_sec",
                    "latency_ms_p50", "latency_ms_p99", "outcomes",
                    "chaos_fired")} for r in res["replays"]],
                "engines_built": len(engines),
                "batches": sum(e.stats()["batches"] for e in engines),
                "warmup_buckets": sum(len(e.buckets) for e in engines)})
    print(json.dumps(out), flush=True)
    return out


def bench_input_pipeline(input_cost_ms: float, batch_size: int = 256,
                         segments: int = 40, seg_iters: int = 12,
                         workers: Optional[int] = None, *,
                         device=None) -> Dict:
    """The reference's input-pipeline A/B (`bench_cli.py
    bench_input_pipeline`): the serial transformer chain against the
    prefetching pipeline (`set_prefetch`), with a sleep of `input_cost_ms`
    a batch standing in for a chain slower than one step. An MNIST-shaped
    MLP (784-256-256-10, tanh) trains through `LocalOptimizer` (SGD
    0.01, momentum 0.9) over 16 seeded batches of `batch_size`.
    `segments` short runs a mode, strictly alternated serial / prefetched
    after a throwaway pair; each run's per-iteration wall times after 5
    warm-up iterations are pooled, and the speedup is the median of the
    pairs' ratios of median iteration times (drift between runs then hits
    both modes alike). `workers` default: one a 5 ms of input cost, at
    least 1, at most `Engine.config["io_threads"]`. Prints and returns
    one JSON object (the reference's keys and the device)."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.dataset import FuncTransformer
    from bigdl_tpu_torch.optim.local_optimizer import LocalOptimizer
    from bigdl_tpu_torch.optim.trigger import max_iteration
    from bigdl_tpu_torch.utils.engine import Engine
    device = resolve_device(device)
    if workers is None:
        io = int(Engine.config["io_threads"])
        workers = max(1, min(io, int(np.ceil(input_cost_ms / 5.0))))
    rs = np.random.RandomState(0)
    batches = [MiniBatch(rs.rand(batch_size, 28, 28).astype(np.float32),
                         (rs.randint(0, 10, batch_size) + 1).astype(np.int64))
               for _ in range(16)]

    def mlp():
        torch.manual_seed(0)
        return (nn.Sequential().add(nn.Reshape([784]))
                .add(nn.Linear(784, 256, device=device)).add(nn.Tanh())
                .add(nn.Linear(256, 256, device=device)).add(nn.Tanh())
                .add(nn.Linear(256, 10, device=device))
                .add(nn.LogSoftMax()))

    def augment(b):
        if input_cost_ms > 0:
            time.sleep(input_cost_ms / 1e3)
        return b

    def run(prefetch: bool, iters: int, warmup: int = 5):
        ds = LocalDataSet(list(batches)).transform(FuncTransformer(augment))
        opt = LocalOptimizer(mlp(), ds, nn.ClassNLLCriterion(), batch_size,
                             device=device)
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(warmup + iters))
        if prefetch:
            opt.set_prefetch(workers=workers)
        times = []
        opt.set_iteration_hook(lambda s: times.append(time.perf_counter()))
        with _bench_telemetry(opt):
            opt.optimize()
        return list(np.diff(times)[warmup:])

    run(False, 5)  # throwaway pair: first-use costs on both paths
    run(True, 5)
    ser, pair_ratios = [], []
    for _ in range(segments):
        s_seg = run(False, seg_iters)
        p_seg = run(True, seg_iters)
        ser += s_seg
        pair_ratios.append(float(np.median(s_seg) / np.median(p_seg)))
    serial = batch_size / float(np.median(ser))
    speedup = float(np.median(pair_ratios))
    out = {
        "metric": "input_pipeline_ab",
        "input_cost_ms": input_cost_ms,
        "batch_size": batch_size,
        "workers": workers,
        "serial_records_per_sec": round(serial, 1),
        "prefetch_records_per_sec": round(serial * speedup, 1),
        "speedup": round(speedup, 3),
        "device": _device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


def _cast_floats(model: torch.nn.Module, dtype: torch.dtype):
    """`model` with its floating parameters cast to `dtype` in place (the
    reference casts the params tree; BN statistics, buffers here, stay
    f32), returned."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def _params_mb(model: torch.nn.Module) -> float:
    """MB (1e6 bytes) of the model's parameter leaves, the reference's
    figure (the params tree; BN statistics are not in it)."""
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e6


def _int8_variants(model: str, batch_size: int, device: torch.device,
                   generator: Optional[torch.Generator]):
    """`bench_int8_serving`'s three eval-mode variants of `model` and its
    seeded bf16 batch on `device`."""
    from bigdl_tpu_torch.models import LeNet5, ResNet
    from bigdl_tpu_torch.nn.quantized import Quantizer
    if model == "lenet":
        float_model = LeNet5(10, device=device, generator=generator)
        in_shape = (28, 28)
    elif model == "resnet50":
        float_model = ResNet(class_num=1000, depth=50, device=device,
                             generator=generator)
        in_shape = (224, 224, 3)
    else:
        raise ValueError(f"model must be resnet50 or lenet, got {model!r}")
    variants = {
        "bf16": _cast_floats(copy.deepcopy(float_model), torch.bfloat16),
        "weight-only int8": _cast_floats(
            Quantizer.quantize(float_model, weight_only=True),
            torch.bfloat16),
        "full int8": Quantizer.quantize(float_model)}
    x = torch.from_numpy(np.random.RandomState(0).rand(
        batch_size, *in_shape).astype(np.float32)).to(device).bfloat16()
    return {k: m.eval() for k, m in variants.items()}, x


def bench_int8_serving(batch_size: int = 256, iters: int = 10,
                       model: str = "resnet50", device=None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """The served model in three variants (the reference's
    `bench_int8_serving`, `bench_cli.py:366`): "bf16" (floating
    parameters cast to bf16), "weight-only int8"
    (`Quantizer.quantize(m, weight_only=True)`, floats cast to bf16) and
    "full int8" (`Quantizer.quantize(m)`, floats kept f32), each in eval
    mode on one seeded bf16 batch (`np.random.RandomState(0)`): one
    forward to build and drain, then `iters` forwards, each reduced to
    `sum(out.float())`, timed on the host clock up to the last sum's
    fetch. Per variant: images/s, ms a forward, the parameters' MB, and a
    forward's launches of kernel 6 (33 at ResNet-50's fused BN+ReLU
    sites; 0 on the CPU, where the plain version runs), of
    `torch._int_mm` (`nn.quantized.int8_mm`; 54 in full int8: 53
    convolutions and the classifier) and of the weight-only layers'
    cuBLAS / cuDNN products (`nn.quantized.float_product`); for the int8
    variants, the top-1 agreement with the bf16 variant on the batch and
    the largest |output difference|. `model`: "resnet50"
    (`ResNet(class_num=1000, depth=50)`, plain stem, 224x224x3) or
    "lenet" (`LeNet5(10)` on 28x28, the reference's CPU-scale model)."""
    from bigdl_tpu_torch.nn.quantized import float_product, int8_mm
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    device = resolve_device(device)
    variants, x = _int8_variants(model, batch_size, device, generator)
    counters = {"bn_relu_fwd": bk.bn_relu_forward, "int8_mm": int8_mm,
                "float_product": float_product}
    out = {"model": model, "batch_size": batch_size, "iters": iters,
           "device": _device_name(device),
           "timer": "host_clock_to_fetch", "variants": {}}
    logits = {}
    with torch.inference_mode():
        for name, m in variants.items():
            float(torch.sum(m(x).float()))  # build, warm and drain
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            for _ in range(iters):
                s = torch.sum(m(x).float())
            float(s)
            dt = (time.perf_counter() - t0) / iters
            row = out["variants"][name] = {
                "images_per_s": batch_size / dt, "ms_per_forward": dt * 1e3,
                "params_mb": _params_mb(m),
                **{f"{k}_per_forward": fn.launches / iters
                   for k, fn in counters.items()}}
            logits[name] = m(x).float().cpu()
            if name != "bf16":
                ref = logits["bf16"]
                row["top1_agreement_with_bf16"] = float(
                    (logits[name].argmax(1) == ref.argmax(1)).float().mean())
                row["max_abs_diff_vs_bf16"] = float(
                    (logits[name] - ref).abs().max())
    return out


#: the int8 profile also files `torch._int_mm`'s cuBLASLt kernels, the
#: im2col's `torch.cat` and the casts on their own
_INT8_KINDS = (("int8 GEMM (torch._int_mm, cuBLASLt)",
                ("imma", "s8s8", "i8i8", "int8")),) + _ZOO_KINDS


def profile_int8_serving(batch_size: int = 256, forwards: int = 4,
                         top: int = 15, model: str = "resnet50", device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict:
    """`_profiled` of each of `bench_int8_serving`'s variants: `forwards`
    forwards after one warm-up; a "step" in each summary is one
    forward."""
    device = _cuda_only(device, "profile_int8_serving")
    variants, x = _int8_variants(model, batch_size, device, generator)
    out = {"model": model, "batch_size": batch_size, "variants": {}}
    with torch.inference_mode():
        for name, m in variants.items():
            m(x)
            torch.cuda.synchronize(device)
            out["variants"][name] = _profiled(
                lambda: [m(x) for _ in range(forwards)], forwards, top,
                device, _INT8_KINDS)
    return out


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("resnet50", "serve", "serve_fleet",
                                       "lm", "attention", "ptb_lstm",
                                       "wide_n_deep", "int8_serving",
                                       "input_pipeline",
                                       "replay_invariance", *ZOO),
                   default="resnet50")
    p.add_argument("--input-cost-ms", type=float, default=20.0,
                   help="with --model input_pipeline: the chain's sleep a "
                   "batch")
    p.add_argument("--attribution", action="store_true",
                   help="print metrics_cli report of each run's stream "
                   "on stderr")
    p.add_argument("--crash", action="store_true",
                   help="with --model serve_fleet: kill replica1 "
                   "mid-traffic (serve.replica_crash)")
    p.add_argument("--profile", action="store_true",
                   help="device time by kind of kernel (torch.profiler)")
    p.add_argument("--replay-model", choices=("mlp", "resnet50"),
                   default="mlp",
                   help="with --model replay_invariance: the served model")
    p.add_argument("--nproc", type=int, default=1,
                   help="ResNet-50 or Wide&Deep data parallel over this "
                   "many ranks")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="the ranks' backend (default: NCCL on cards)")
    p.add_argument("--model-axis", type=int, default=1,
                   help="with --model lm --nproc N: ranks on the mesh's "
                   "model axis (tensor parallel)")
    p.add_argument("--telemetry", metavar="STEM", default=None,
                   help="stream every training run's records to "
                   "STEM.jsonl and its spans to STEM.trace.json")
    p.add_argument("--chaos", action="store_true",
                   help="the crash drill: a train.step fault, the retry "
                   "policy's reload, MTTR")
    p.add_argument("--chaos-crash-at", type=int, default=None,
                   help="the step the crash drill faults (implies --chaos)")
    p.add_argument("--device-loss", action="store_true",
                   help="the elastic drill: a worker lost and back "
                   "(implies --chaos)")
    p.add_argument("--dp-child", action="store_true",
                   help=argparse.SUPPRESS)
    for flag, default in (("--batch-size", 128), ("--warmup", 8),
                          ("--iters", 16), ("--sync", 8)):
        p.add_argument(flag, type=int, default=default,
                       help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="torch device of --chaos / --device-loss / "
                   "--model replay_invariance (default: the card)")
    args = p.parse_args(argv)
    if args.telemetry:
        os.environ[TELEMETRY_ENV] = os.path.abspath(args.telemetry)
    if args.attribution:
        os.environ[ATTRIBUTION_ENV] = "1"
        os.environ.setdefault(TELEMETRY_ENV,
                              os.path.abspath("bench_attribution"))
    if args.dp_child:
        return _dp_child(args)
    if args.chaos or args.device_loss or args.chaos_crash_at is not None:
        # --device-loss alone runs the elastic drill (never the default
        # benchmark), as the reference's flag does
        if args.device_loss:
            bench_chaos_device_loss(device=args.device)
        else:
            bench_chaos(crash_at=args.chaos_crash_at or 8,
                        device=args.device)
        return
    if args.model_axis > 1 and (args.model != "lm" or args.nproc < 2):
        p.error("--model-axis takes --model lm and --nproc")
    if args.nproc > 1:
        if args.model not in DP_MODELS or args.profile:
            p.error("--nproc runs the ResNet-50, Wide&Deep and LM "
                    "benchmarks only, without --profile")
        kw = dict(warmup=2, iters=6, sync=2) if args.model == "lm" else {}
        print(json.dumps(bench_dp(args.model, args.nproc,
                                  backend=args.backend,
                                  model_axis=args.model_axis, **kw)))
        return
    if args.model == "serve_fleet":
        if args.profile:
            p.error("--model serve_fleet takes no --profile")
        bench_serve_fleet(crash=args.crash)
        return
    if args.model == "replay_invariance":
        if args.profile:
            p.error("--model replay_invariance takes no --profile")
        bench_replay_invariance(model=args.replay_model, device=args.device)
        return
    if args.model == "input_pipeline":
        if args.profile:
            p.error("--model input_pipeline takes no --profile")
        bench_input_pipeline(args.input_cost_ms, device=args.device)
        return
    if args.model == "int8_serving":
        fn = profile_int8_serving if args.profile else bench_int8_serving
    elif args.model == "attention":
        fn = profile_attention if args.profile else bench_attention
    elif args.model == "serve":
        fn = profile_resnet50_serving if args.profile \
            else bench_resnet50_serving
    elif args.model == "lm":
        fn = profile_transformer_lm if args.profile else bench_transformer_lm
    elif args.model == "ptb_lstm":
        fn = profile_ptb_lstm if args.profile else bench_ptb_lstm
    elif args.model == "wide_n_deep":
        fn = profile_wide_n_deep if args.profile else bench_wide_n_deep
    elif args.model in ZOO:
        fn = functools.partial(profile_zoo if args.profile else bench_zoo,
                               args.model)
    else:
        fn = profile_resnet50 if args.profile else bench_resnet50
    print(json.dumps(fn()))


if __name__ == "__main__":
    main()
