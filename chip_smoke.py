#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`bigdl_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases:
1. device: print the card's name and power limit (`nvidia-smi`); no CUDA
   device is a failure;
2. build: compile every CUDA kernel of the port from `bigdl_tpu_torch/csrc`
   with `nvcc` (one process per source, started together); for the
   kernels with a bf16 tensor-core design beside the CUDA-core one (1, the
   flash forward; 2, the ring hop; 3-4, the flash backward; 5, the stem)
   print each
   compiled kernel's registers and spill bytes (ptxas) and its HMMA
   instructions (`cuobjdump -sass`), and check that the bf16 design has
   HMMA at every compiled width (DMAX 64 and 128; the stem's KT 2, 4, 6),
   spills nothing at D <= 64 (the stem: KT = 4), and that no CUDA-core
   kernel has HMMA;
3. kernel: hold the flash-attention forward kernel against its plain
   PyTorch version at the prefill shapes and edge cases (ragged, fully
   masked rows through k_offset, D = 128, non-causal D = 40), each in f32
   (the CUDA-core design) and bf16 (the tensor-core design), and bf16
   inputs 2 bytes past a 16-byte boundary (the same bits as aligned
   ones), with stated tolerances and a second launch bitwise equal; time
   it beside the plain version, `scaled_dot_product_attention` (a
   yardstick only; the port never calls it) and its bound;
4. generation: serve `TransformerLM(vocab 1024, embed 512, 4 layers,
   8 heads)` with random weights from a seed through `GenerationEngine`,
   check every stream, the kernel's launch count, and the greedy tokens
   against `greedy_decode_reference` on a twin without the kernel;
5. BN+ReLU kernels: hold the fused forward and backward kernels against
   their plain versions at ragged shapes and at the ResNet-50 sites (the
   stem, N = 128*112*112, C = 64; the last stage, N = 128*7*7, C = 512),
   for x f32 / out bf16, x f32 / out f32 and x bf16 / out bf16, with and
   without the ReLU: forward and dx bitwise, dscale/dshift within
   1e-5 * sum|terms| per channel, a second backward launch bitwise equal,
   one device kernel a backward call; time each beside its plain version
   and its bound. Then each of the eight distinct ResNet-50 b128 sites with x,
   y and g in bf16 (the main path's dtypes): the same checks, a second
   backward launch bitwise equal, exactly one device kernel a backward
   call (the profiler), and its forward and backward device times beside
   their bounds, summed over the step's 33 sites;
6. training: ResNet-50 (1000 classes, s2d stem, full width and depth,
   random weights from a seed). First an f32 parity pair at b8, 224x224:
   the model and a twin with the same weights under `fusion_scope(False)`
   (no kernel) take 3 SGD steps through `DistriOptimizer`; their losses
   agree to a relative 1e-4 and the model launches each kernel 33 times a
   step. Then the benchmark configuration (`bigdl_tpu_torch/tools/
   bench.py`: b128, bf16 compute with f32 masters, SGD momentum 0.9, one
   resident batch) for 8 warm-up and 24 timed steps, syncing every 8:
   imgs/s, ms/step, exactly 33 launches of each kernel a step, and a
   finite loss that falls from the first step to the last;
7. flash backward kernels: hold the dq and dk/dv kernels against their
   plain versions (causal T=2048 at B*H=64, ragged T=1000, non-causal
   Tq=1000 Tk=1500, D=128, rows fully masked through q_offset, each in
   f32, which runs on the CUDA cores, and in bf16, which runs on the
   tensor cores), per element within 1e-4 * max|plain| in f32 and one
   bf16 ulp (2**-7 * |plain|) more in bf16, and a second launch bitwise
   equal;
   kernel 1's O and lse in each case against its plain version with the
   tolerances of phase 3; time each beside its plain version, its bound
   and the backward of `scaled_dot_product_attention` (a yardstick only),
   and kernel 1 at the training shape;
8. LM training: `TransformerLM(vocab 1024, embed 512, 4 layers, 8 heads)`
   with random weights from a seed. (a) An f32 parity pair at b2, T=512:
   the model and a `use_flash=False` twin (no kernel) take 3 SGD steps
   through `DistriOptimizer` on the averaged per-token loss; their losses
   agree to a relative 1e-4, each of kernels 1, 3 and 4 launches 12 times
   and the twin none. (b) The benchmark configuration (`bigdl_tpu_torch/
   tools/bench.py --model lm`: b8, T=2048, bf16 compute with f32 masters,
   SGD momentum 0.9 on the loss summed over T, 12 warm-up + 36 timed
   steps, sync every 12): tokens/s, ms/step, exactly 4 launches of each
   kernel a step, and a finite first loss within [ln 1024, ln 1024 + 2]
   per token. The recipe's later losses diverge, in the reference as
   here, so no fall is required. (c) The example
   (`bigdl_tpu_torch/tools/transformer_lm.py`) at its defaults: AdamW with
   warm-up and cosine decay, a train-shard perplexity below 25, and the
   T=256 eval forward;
9. sequence parallelism: (a) hold the flash carry kernel (kernel 2, one
   ring hop) against its plain version in f32 and bf16 at D = 64, 128 and
   40: a two-hop continuation that, finished, matches kernel 1 over the
   whole K/V, ragged Tq/Tk, a diagonal hop, a hop wholly in the queries'
   past (equal bits to causal=False), a hop wholly in their future (the
   carry passes through bitwise), rows still fully masked (m = NEG_INF,
   l = 0 in and out), and a second launch (equal bits): acc within
   1e-5 * max|plain|, m and l within 1e-5 * max(|plain|, 1); bf16 runs
   the tensor-core design, f32 the CUDA-core one. Time it at the
   full-width hop shapes (the ring's B1 H8 T=2048 D64 diagonal and
   below-diagonal hops, zigzag's T=1024 chunk; bf16, then f32) beside
   its plain version, its bound and kernel 1 in the same dtype at the
   same shape and offsets. (b) Ring,
   zigzag and Ulysses through `make_sequence_parallel_attention`, causal, B1 H8 T=8192 D64 bf16, over
   a mesh of every card (4 shards on the one card when there is one):
   each within one bf16 ulp of kernel 1 over the whole sequence
   (|d| <= 2**-7 |ref| + 1e-4 max|ref|), kernel 2 launched n^2, n(2n+1)
   and 0 times a call; timed beside kernel 1 (with its bound) and
   `scaled_dot_product_attention` (a yardstick only) over the whole
   sequence. (c) Ring and zigzag gradients of sum(out**2) for q, k and v,
   f32, T=2048, against `flash_attention` (kernels 1, 3, 4) on the whole
   sequence, within 1e-4 * max|ref|;
10. the space-to-depth stem (kernel 5). (a) Hold the stem kernel against
   its plain version in f32 and bf16, with and without the bias, for
   k = 3, 7, 11 and C_in = 1, 3 at a ragged x2 of 113x115 (a 226x230
   input), and at the served (b32, x2 [32, 112, 112, 12], O = 64, f32)
   and training (b128, bf16) shapes: per element within 1e-5 *
   max|plain|, plus one bf16 ulp (2**-7 * |plain|) in bf16, and a second
   launch bitwise equal; time it at the two full-width shapes beside its
   plain version, its bound and both cuDNN forms of the same function
   (`F.conv2d` 7x7/s2 on the channels_last image; the 4x4 stride-1
   convolution over the pre-padded 12-channel x2), yardsticks only.
   (b) Serve `ResNet50(class_num=1000, s2d_stem=True)` (224x224x3, random
   weights from seed 0, f32, TF32 off) through
   `InferenceEngine(max_batch_size=32, max_wait_ms=2)` with
   `BIGDL_TPU_PALLAS_STEM=1`, after `warmup`: a burst of 96 requests and a
   closed loop of 8 clients x 8 requests. Every request resolves, each row
   is within 1e-4 * max|twin row| of a `LocalPredictor` twin with the
   cuDNN stem and the same argmax wherever the twin's top-2 margin exceeds
   1e-3, and kernels 5 and 6 each launch exactly once a batch dispatched
   plus once a warm-up bucket; with the switch unset kernel 5 launches
   never. Requests/s, latency percentiles, batch-size p50, bucket hit
   rate, and the device ms of one b32 forward with kernel 5's share.
   (c) A plain-stem `ResNet50()` (randomized BN state) through
   `LocalPredictor` at b8: 0 BNs left, an s2d stem with a bias, outputs
   within 1e-4 * max|ref| of the unconverted model in eval mode, kernel 5
   once a batch. (d) Phase 6's f32 parity pair with the switch set against
   a twin with it unset (losses within a relative 1e-4, kernel 5 once a
   step), then `tools/ab_stem.py`: the stem micro-benchmark (b128 bf16)
   and a short full loop (8 warm-up + 24 timed steps) with and without
   kernel 5.

11. the training loop's accounting and safety net. (a) ResNet-50 (s2d
   stem, random weights from seed 0) at b128 in bf16 with f32 masters,
   SGD momentum 0.9, over three seeded batches of 128 reshuffled every
   pass, for 12 steps with `set_validation(several_iteration(4))` on a
   held-out seeded set of 256 images ([Top1Accuracy, Top5Accuracy,
   Loss]), `set_gradient_clipping_by_l2_norm(1.0)` and
   `set_checkpoint(tmp, several_iteration(4), keep_last_n=2)`, under
   `torch.use_deterministic_algorithms(True, warn_only=True)` with cuDNN
   deterministic: exactly 2 checkpoints are left, and a fresh process
   resumed from the step-8 checkpoint trains steps 9-12 to the same losses
   and parameters bit for bit (within a relative 1e-3, with the ops named,
   if an op of the path warned that it is not deterministic); kernels 6-7
   launch 33 times a step. (b) The same at b32 through `Optimizer(...,
   local=False, retry_policy=RetryPolicy(max_retries=3, base_delay_s=0.05,
   seed=0))` with a `train.step` fault at the 6th step: the run recovers
   from the step-4 checkpoint, reaches step 12, and its losses after the
   recovery equal the unfaulted run's; the time to recover is printed.
   (c) `Evaluator(model, 32).test` of (a)'s model on the card against the
   same methods on the CPU (the plain kernels) over 64 held-out images:
   the loss within a relative 1e-4, the Top1/Top5 counts equal but for
   rows whose deciding margin is under 1e-3. (d) The LM at b8, T=2048, f32
   with TF32 off: one step with `set_gradient_accumulation(2)` against the
   same step without it (each updated parameter within 1e-4 of its
   tensor's largest element, launches of kernels 1, 3, 4 twice as many),
   then the
   benchmark recipe in bf16 for 12 steps with
   `set_gradient_clipping_by_l2_norm(1.0)` (its losses printed). (e) The
   FLOP count and `mfu` of each `tools/bench.py` path (`resnet50` and
   `lm` from phases 6 and 8, `serve` and `attention` here): every mfu in
   (0, 1) against `costs.peak_flops` of the card, which must be in the
   registry; and a small ResNet and LM step counted on the card, on the
   CPU and on the meta device give one number.

12. the feed-forward zoo. (a) Kernel 5 with its bias at Inception-v1's
   b64 shape (x2 [64, 112, 112, 12], O = 64; f32, and bf16 with the bias
   as the bf16 copy of its master), and kernels 6-7 at Inception-v2's 7x7
   C=352 and 28x28 C=96 sites and VggForCifar10's 2-D [32, 512] site (x
   bf16 as the main path hands it, and f32; y and g bf16, the backward's g
   a channel slice of a wider Concat gradient, read in place with no
   copy), each against its plain
   version with phases 10's and 5's limits, timed beside its bound
   (kernels 6-7 there also by the profiler: their device time is below
   a launch's host cost, which back-to-back CUDA events measure).
   (b) f32 parity pairs through `DistriOptimizer`, 3 SGD steps each:
   `Inception_v1_NoAuxClassifier(1000, s2d_stem=True)` at b8 with the
   stem kernel on against a `pallas_stem=False` twin;
   `Inception_v2_NoAuxClassifier(1000)` at b8 and `VggForCifar10(10)` at
   b16, 32x32, against `fusion_scope(False)` twins. Twins share the
   weights and the step generator's seed (so the dropout masks): losses
   within a relative 1e-4; kernel 5 once a step, kernels 6 and 7 69
   (v2) and 14 (Cifar VGG) times a step, the twins none. (c) The
   `tools/bench.py --model lenet | inception_v1 | inception_v2 | vgg16`
   configurations (b512, b64 with the stem kernel on, b32, b32; bf16
   compute, f32 masters) for 8 warm-up and 24 timed steps: imgs/s,
   ms/step, the FLOP count, mfu in (0, 1), a finite first loss and a
   last loss below it, and exact launches (kernel 5 once a step for
   Inception-v1, kernels 6-7 69 times and no gradient copy for
   Inception-v2). (d) Phase 12's wall time.

13. the recurrent path and the rest of the training loop; no kernel of
   the port runs on it (the reference's LSTM reaches no Pallas kernel).
   (a) f32 on the card (TF32 off) against the port on the CPU, from the
   same weights and batch, through `DistriOptimizer`:
   `PTBModel(10001, 200, 10001)` at b8, T=20, 3 SGD steps (momentum
   0.9); `SimpleRNN(4, 40, 4)` at b8, T=20, 3 steps under each of
   `LAMB`, `Adagrad`, `Adadelta`, `Adamax`, `RMSprop` and `Ftrl`, and 6
   SGD steps under `SequentialSchedule(Warmup, Poly)`: losses (and the
   SimpleRNN's parameters, relative to each tensor's largest element)
   within a relative 1e-4, and the learning rate of every step equal.
   (b) `tools/bench.py --model ptb_lstm` (b64, T=20, bf16 compute with
   f32 masters, SGD momentum 0.9, one resident batch of seeded 1-based
   ids) for 8 warm-up and 24 timed steps, syncing every 8: records/s,
   tokens/s, ms/step, the FLOP count, mfu in (0, 1), a first loss within
   10% of T ln V and a last loss below it, and no launch of any kernel
   of the port (every count set to 0 before the run, read after).
   (c) The example (`tools/language_model.py` at its defaults): its
   perplexity below the corpus's vocabulary size (200). (d) Phase 13's
   wall time.

14. data parallel over `torch.distributed`, one process a rank, every
   rank running kernels 6-7 at ResNet-50's 33 fused sites with the BN
   statistics taken over the global batch. First kernels 6-7 against
   their plain versions at a rank's b64 shapes (x bf16, as the main path
   hands it, and f32), as in phase 5. (a)
   ResNet-50 b128 bf16 (phase 6's configuration, 4 steps, deterministic)
   under an NCCL group of world size 1 against no group: no collective
   issued, losses and parameters within PARITY_RTOL (in practice the same
   bits), 33 launches of each kernel a step. (b) Two ranks sharing the
   card over an explicitly named gloo group (`--dp-child`; the kernels
   are built here first, so the ranks only load them): an f32 parity run
   (TF32 off, deterministic, ResNet-50 at global b16, 3 SGD steps)
   against one process on the whole batch (the limits at DP_LOSS_RTOL,
   DP_UPDATE_RTOL and DP_STAT_RTOL), then `tools/bench.py resnet50_rank`
   at global b128 (64 a rank) for 8 + 16 steps: ms a step and imgs/s a
   rank, a falling loss on each rank, 33 launches of each kernel a step a
   rank, one gradient all-reduce a bucket and 212 BN all-reduces a step,
   and the time of a step's collectives issued alone. These times are two
   processes time-sharing one card through host-staged gloo: a check
   that the path works, not a scaling figure. (c) With several cards, the
   parity and full-width runs over NCCL, one rank a card (up to 4); with
   one, it prints that multi-card numbers are not measured. A rank that
   fails, times out or disagrees fails the phase.

15. Wide&Deep (`BASELINE.md` config 5, `WideAndDeep(2, wide_dim=100,
   embed_vocabs=(10, 10), embed_dim=4, cont_dim=3)`), a four-tensor input
   the model takes as the 1-based `Table`; no kernel of the port runs on
   it (the reference's Wide&Deep reaches no Pallas kernel). (a) b1024 in
   f32 on the card (TF32 off) against the CPU, one seed, 8 SGD steps
   (momentum 0.9) through `DistriOptimizer`: losses within a relative
   1e-5 and each parameter within 1e-5 of its tensor's largest element.
   (b) `tools/bench.py --model wide_n_deep` (b1024, bf16 compute with f32
   masters, one resident batch) for 8 warm-up and 24 timed steps, syncing
   every 8: records/s, ms/step, every step's loss (the last below the
   first), the FLOP count and mfu in (0, 1). (c) Its `--profile`: device
   busy and idle shares, launches a step, device ms by kind of kernel.
   (d) The launches of each of the seven kernels during (b): every count
   0. (e) The example (`tools/wide_n_deep.py` at its defaults): train
   accuracy of `wide_n_deep` at least 0.85. (f) 64 four-feature requests
   through `InferenceEngine` (the model behind a `ConcatTable`, so the
   engine gives `y[1]`): within 1e-6 of the model's b64 forward, as
   `LocalPredictor`'s. (g) `--nproc 2` over gloo on the one card: each
   rank's loss falls, one gradient all-reduce a step. (h) Phase 15's wall
   time.

16. tensor parallelism: the LM (`TransformerLM(vocab 1024, embed 512, 4
   layers, 8 heads)`, weights from seed 0) over a (data, model) mesh of
   ranks (`Engine.get_mesh`, `DistriOptimizer`'s default `ShardingRules()`:
   26 of its weight matrices split over "model"), one process a rank
   (`--tp-child`): four gloo ranks sharing the card (NCCL refuses two ranks
   on one device), NCCL with one rank a card where the machine has four.
   (a) f32 (TF32 off, deterministic) at T=256, global b8, 4 SGD steps:
   (2, 2) against (2, 1) on the same data, every loss and every parameter
   bitwise; against one process on the whole batch, losses within a
   relative 1e-5 and parameters within 1e-5 of each tensor's largest
   element; every sharded parameter stored on each rank at exactly half
   its shape; 16 launches of each of kernels 1, 3 and 4 on each rank. (b)
   `tools/bench.py --model lm --nproc 4 --model-axis 2`: global b8 at
   T=2048 (b4 a data replica), bf16 with f32 masters, SGD momentum 0.9, L2
   clipping at 1.0, 2 warm-up and 6 timed steps: ms a step, tokens/s, the
   all-gathers and gradient all-reduces a step with their bytes, each
   rank's bytes of parameters and optimizer state, exactly 4 launches of
   each of kernels 1, 3 and 4 a step on every rank, and a finite loss that
   falls from the first step to the last. (c) (a)'s (2, 2) run saves a
   sharded checkpoint (`torch.distributed.checkpoint`) at step 2: a fresh
   4-rank launch resumes from it and matches steps 3-4 bitwise; a (2, 1)
   launch and this process (no group) restore the step-2 parameters
   bitwise. (d) Phase 16's wall time.

17. the observability core (`bigdl_tpu_torch.observability`) on the
   main paths. (a) Phase 8's LM recipe (b8, T=2048, bf16 compute with
   f32 masters, SGD momentum 0.9, kernels 1, 3 and 4) through
   `DistriOptimizer` for 5 steps syncing every step, under
   `Telemetry(JsonlSink, InMemorySink, grad_norms=True)`, a `SpanTracer`,
   `NanGuard("skip")`, `StragglerDetector` and `ThroughputMonitor`, with
   the third batch poisoned (token ids carry no NaN: the model multiplies
   a float gate into its embeddings, 1.0 on clean batches and NaN on the
   poisoned one), under phase 11's deterministic settings: every record
   validates and the JSONL file is strict JSON, the steps are numbered
   1..5, exactly one non-finite step, finite losses after it, 4
   launches of each kernel a step, the trace has the loop's spans, and
   the parameters and momentum after [clean, clean, poisoned] equal, bit
   for bit, those after [clean, clean] (within a relative 1e-3, with the
   ops named, if an op warned that it is not deterministic). (b) Phase
   4's generation configuration, every request queued before the
   dispatcher starts, without and then with a telemetry and a tracer:
   the same greedy tokens, one `trace` record per request, kernel 1 once
   a layer a prefill batch. (c) Phase 10(b)'s served ResNet-50 burst of
   96 with a telemetry (a `serving_stats` record a batch) and a tracer:
   one `trace` record per request, the records validate, kernels 5 and 6
   once a batch and a warm-up bucket. (d) The ms a step of the LM (b8,
   T=2048, clipped at 1.0 as in 11(d)) and of ResNet-50 (b128) with and
   without (a)'s instrumentation, in turns from the same weights:
   printed, not gated.
   `python3 chip_smoke.py --phase17` runs phases 1, 2 and 17 alone.
18. elastic training and preemption (`DistriOptimizer.set_elastic`,
   `set_preemption_handler`, `resilience/{membership,elastic,
   preemption}.py`). (a) Phase 6's ResNet-50 (cuDNN stem, kernels 6-7 at
   33 sites) at global b128 224x224x3, bf16 compute with f32 masters, SGD
   momentum 0.9, elastic over 4 logical replicas on `SimulatedCluster(4)`
   over four slots of the card, bucketing on, sync every 2, 12 steps, 4
   distinct seeded batches fed in order, under phase 11's deterministic
   settings: `mesh.device_loss` loses worker3 at hit 5, the iteration
   hook restores it at step 8, `mesh.collective` fails at hit 10. The run
   reaches step 12; `fault_injected`, `worker_lost`, `elastic_shrink` (4
   -> 3, degraded 0.25), `elastic_replay`, `elastic_grow` (3 -> 4) and
   `elastic_rebuild` come in that order; the synced losses, parameters,
   momentum and BN statistics equal an uninterrupted elastic run's bit
   for bit (within a relative 1e-3, with the ops named, if an op warned
   that it is not deterministic); kernels 6 and 7 launch 33 times a shard
   dispatch; it prints the MTTR (`worker_lost` to the first step record
   after it), the replayed batches, the commit ms and the ms a step. (b)
   Phase 8's LM recipe clipped at 1.0 through `DistriOptimizer` with a
   preemption handler and a checkpoint directory, SIGTERM from the hook
   at step 3 of 6: `optimize()` returns at step 3, one `preempted`
   (checkpointed) then `run_abort`, the disposition restored, a fresh
   optimizer resumed from the checkpoint ends with the uninterrupted
   run's losses of steps 4-6 and parameters bit for bit (the same
   fallback), 4 launches of each of kernels 1, 3, 4 a step. (c)
   `tools/bench.py --device-loss` on the card: recovered, grown back, a
   replayed batch. (d) `tools/transformer_lm.py --sequence-parallel ring`
   and `zigzag` at `--long-len 2048` on the repeated card match
   `naive_attention`, kernel 2 launching n^2 and n(2n+1) times. (e) the
   phase's wall time. `python3 chip_smoke.py --phase18` runs phases 1, 2
   and 18 alone.
19. int8 post-training quantization (`nn/quantized.py`: the int8 x int8
   -> int32 products through `torch._int_mm`, cuBLASLt on the card; no
   TPU kernel of the reference computes them). (a) Each full-int8 layer
   on the card against the same module's forward on the CPU:
   `QuantizedLinear` 2048->1000 at M = 1, 17 and 256, and
   `QuantizedSpatialConvolution` at ResNet-50's stem (7x7/s2, K = 147,
   b8 224x224x3), a 3x3 C=64 site and a 1x1/s2 shortcut (b8 56x56), and a
   grouped (g=2) dilated (d=2) SAME convolution: int8 weights, scales and
   int32 sums equal, the output bitwise for an f32 x and within 1e-6
   relative for a bf16 x (reported bitwise or not); the weight-only twin
   within 0.03 relative of its float layer (f32, the reference's bound);
   each layer's device ms in bf16 beside the bf16 float layer's. (b)
   `tools/bench.py --model int8_serving`: ResNet-50 (plain stem) b256 in
   bf16, weight-only int8 and full int8, 10 timed forwards each: images/s,
   the parameters' MB, 33 launches of kernel 6 a forward in each, 54
   `_int_mm` calls a full-int8 forward and 54 cuBLAS / cuDNN products a
   weight-only one, each int8 variant's top-1 agreement with bf16. (c)
   `ResNet(1000, depth=50, s2d_stem=True)` (f32, randomized BN state,
   TF32 off, `BIGDL_TPU_PALLAS_STEM=1`: the stem stays float and runs
   kernel 5) quantized both ways, a burst of 96 through
   `InferenceEngine(convert=False, max_batch_size=32, max_wait_ms=2)`:
   every row bitwise equal to `LocalPredictor(convert=False)`'s in full
   int8, within 1e-2 relative in weight-only; kernel 5 once, kernel 6 33
   times and the products 53 times a batch; requests/s, latency
   p50/p95/p99, batch-size p50. (d) The phase's wall time.
   `python3 chip_smoke.py --phase19` runs phases 1, 2 and 19 alone.
20. the serving fleet (`serving/fleet.py`, the engines' breaker,
   `tools/bench.py serve_fleet_drill`). (a) The reference's serve_fleet
   drill with the crash over phase 10(b)'s served ResNet-50 (224x224,
   f32, TF32 off, the stem switch set): 3 `InferenceEngine` replicas
   sharing the card (max batch 8, `max_wait_ms` 1, reject on full; drain
   grace 0.5 s), 6 closed-loop clients x 40 requests with session
   affinity in windows of 4, `serve.replica_crash` on replica1 once 25-75%
   resolved: every request ok, rerouted or timed out (0 other), one
   drain, a measured MTTR, every ok row within SERVE_ATOL of the
   cuDNN-stem twin's row for its image; kernels 5 and 6 launch, each,
   the dispatched batches plus the warm-up buckets of every engine built
   (the killed one included); `restore("replica1")` re-warms it (2
   warm-ups) into rotation. It prints MTTR, degraded throughput,
   reroutes, drains, requests/s and the client-side p50/p99. The
   replicas share one card: no figure is a scaling figure. (b) One
   engine with `breaker={"failure_threshold": 2}` and a `serve.forward`
   plan on bucket 8: two poisoned bursts trip it, `health()` is degraded
   with that bucket open, the next burst of 8 sheds with
   `ServingUnavailableError` while kernel 5's count stays put, bucket 2
   serves throughout (rows against the twin), and after the reset
   timeout one probe batch closes it. (c) 2 `GenerationEngine` replicas
   over phase 1's LM (slots 8, max_len 2048, prefill batch 4) through
   `engine_factory`, 8 sessions of 32 tokens over phase 1's first eight
   prompt lengths; the replica of session 0 is failed once that stream
   delivered 3 tokens: every stream completes 32 tokens, at least one
   restarts on the survivor, each spliced stream passes `check_tokens`,
   kernel 1 launches 4 times a prefill batch (warm-up included) over
   both replicas. (d) The phase's wall time. `python3 chip_smoke.py
   --phase20` runs phases 1, 2 and 20 alone.
21. pipeline and expert parallelism (`parallel/pipeline.py`,
   `parallel/moe.py`) and `DistriPredictor`, TF32 off. (a) The ImageNet
   ResNet-50 (224x224, 1000 classes, f32, zero-initialized BN gammas drawn
   from U(0.05, 0.15)) split by `split_sequential(model, 4)` (the stem's
   BN -> ReLU pair inside stage 0) as `PipelineStages` over a "pipe" mesh
   of `["cuda"] * 4`, n_micro 8, a seeded batch of 64, mean
   `ClassNLLCriterion` over the model's `LogSoftMax`: 4
   `train_step_1f1b` steps, each followed by p -= 0.05 g, against the
   microbatch oracle (`tools/pipeline_resnet.py microbatch_oracle`: each
   microbatch through the stages' sequential forward and backward, loss
   / M, gradients summed; per-microbatch BN statistics as in 1F1B) run 4
   steps from the same parameters: step 1's loss within 1e-5 relative,
   every gradient within 1e-4 of its tensor's largest element, the
   update after 4 steps within 1e-3 of its norm (cuDNN's f32 backward
   is not deterministic; the worst tensor is printed); kernel 6
   528 = 33 x 8 x 2 launches a step (F ticks and B-tick recomputes),
   kernel 7 264 = 33 x 8; every BN buffer unchanged. It prints ms a step
   and the peak memory of each step, for both. (b) `GPipe` over 4
   `TransformerBlock(512, 8, causal=True)` (distinct seeded weights, bf16)
   on a "pipe" mesh of `["cuda"] * 4`, x 8 x 2048 x 512 bf16, n_micro 4:
   `pipeline_apply` against the sequential forward per element within
   2e-2 * max(1, |seq|) (phase 3's bf16 limit; bitwise reported), kernel
   1 16 = 4 x 4 launches a call, ms a call beside the sequential
   forward's. (c) `MoE` at Switch-Base-8's width (d_model 768, d_ff 3072,
   8 experts, capacity factor 1.25), top-1 and top-2, 4096 tokens on an
   "expert" mesh of `["cuda"] * 4`, the router skewed by 2.0 * N(0, 1)
   and the tokens N(0.1, 1) (centred tokens drop nothing at this width):
   `expert_parallel_apply`'s drop masks equal `dense_capacity_apply(
   n_groups=4)`'s, outputs within 1e-4 of the largest element; dropped
   units, `apply_with_aux`'s statistics, ms a call of each path. No
   kernel of the port runs there. (d) `DistriPredictor(model, 32, mesh)`
   over phase 10(b)'s served ResNet-50 (224, f32, randomized BN state,
   `BIGDL_TPU_PALLAS_STEM=1`, `convert=True`) on a "data" mesh of every
   card, or `["cuda"] * 2` on one: 101 seeded images (the last batch of 5
   padded), every row within SERVE_ATOL of `LocalPredictor`'s, the same
   `predict_class`, kernels 5 and 6 once per batch per distinct device.
   (e) The phase's wall time. `python3 chip_smoke.py --phase21` runs
   phases 1, 2 and 21 alone.
22. the operations stack (`observability/{slo,export,compilation}.py`,
   `tools/metrics_cli.py`, `workload/diff.py`, `visualization/`,
   `dataset/prefetch.py`), TF32 off. (a) ResNet-50 (1000 classes, s2d
   stem, seed 0) at b128 224x224x3, bf16 with f32 masters, SGD momentum
   0.9, 8 + 24 steps synced every 8 through `DistriOptimizer` under
   `Deterministic`, fed by 8 seeded raw uint8 batches (256x256x3) in a
   fixed cycle through a numpy chain (a random 224 crop and a flip drawn
   from each batch's own seed, then normalize), once serial and once with
   `set_prefetch(workers=4)` (pinned batches, `non_blocking` copies):
   the two runs' losses bitwise equal, kernels 6 and 7 33 launches a step
   each (the prefetched run's one validation forward adds 33 of kernel
   6), no thread left; the prefetched run's step records carry the
   `prefetch_*` gauges; its `TrainSummary` (a `Parameters` histogram
   every 8 iterations) and `ValidationSummary` (Top1 on one held batch)
   read back through `FileReader`, Loss equal to the step records' losses
   in float32; its stream holds one `compile` record whose `flops` equal
   `flops_per_step`, and `metrics_cli report` exits 0. Printed: ms a step
   (the step records' sync windows after the warm-up) and images/s of
   each run and the gauges. (b) Phase 20(a)'s drill with its crash (3
   ResNet-50 replicas with breakers, kernels 5-6, the stem switch set),
   four times on fresh fleets (P22_DRILLS): unwatched, then under a live
   `SloEngine(default_slos())` and a `PrometheusTextSink` tracking every
   replica behind a `MetricsServer` on 127.0.0.1:0, scraped with `urllib`
   every 0.1 s during the drill and once after it (twice), then
   unwatched again. A watched drill's last scrape holds the serving
   counters, the per-bucket breaker gauges, the `serving_fleet_*` gauges
   and an `slo_burn_rate` line for each objective. On every drill's JSONL
   stream `metrics_cli slo --check --mttr-s 60 --latency-p99-ms
   P22_DEADLINE_MS` (the drill's deadline) exits 0, and the default 100
   ms ceiling's verdict is printed beside it; on the first watched
   stream, cut after its `worker_lost`, the gate exits 1, and `metrics_cli
   diff` of the stream with itself exits 0 and with one outcome changed
   1; kernels 5 and 6 launch once a dispatched batch and once a warm-up
   bucket. Printed: each drill's client and engine latency tail, so the
   watched and unwatched drills compare. (c) (a)'s serial run again
   with an `SloEngine` and a `PrometheusTextSink` on its telemetry: its
   ms a step beside (a)'s. (d) The phase's wall time. `python3
   chip_smoke.py --phase22` runs phases 1, 2 and 22 alone.

Prints a `{"kernels": [...]}` line (each row with the `design` its main
measure ran: `tensor_cores` or `cuda_cores_f32` for rows 1-5, the octet
designs of rows 6-7 (`BN_DESIGN`); rows 6-7 at the main path's dtypes
(x, y and g bf16) with the x-f32 stem case beside them and the eight
ResNet-50 sites (`resnet50_sites`); rows 5-7 with their
launches on the zoo's paths and their zoo shapes; rows 6-7 with their
launches on each rank of phase 14(b) and their time at a rank's b64
stem site; rows 1, 3 and 4 with their launches on each rank of phase
16(b), `launches_tp_ranks`, in phase 17(a), `launches_observed_lm`, and
in phase 18(b), `launches_preempt_lm`; rows 6-7 with their launches in
phase 18(a), `launches_elastic`; rows 5-6 with their launches in phase
19(b)-(c), `launches_int8_serving`; rows 1, 5 and 6 with their
launches in phase 20, `launches_fleet`; rows 1, 5, 6 and 7 with their
launches on phase 21's paths, `launches_pipeline`; rows 5, 6 and 7
with their launches on phase 22's paths, `launches_ops`),
then as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero.
"""

from __future__ import annotations

import os

# cuBLAS's workspace for phase 11's deterministic runs, in this process and
# the one it starts; 8 x 4 MiB is already torch's default on sm_90, so the
# earlier phases run as before
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import copy
import functools
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# f32 on the CUDA cores and the memory rate. The bf16 tensor-core peak is
# `observability.costs.peak_flops` of the card, set in main().
PEAK_FLOPS = {torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# |kernel - plain| limits. f32: both sum the same f32 terms in another
# order (2048 keys), ~1e-6 apart; a wrong mask or guard is off by >1e-2.
# bf16: O is rounded to bf16 (one ulp at |O| ~ 2 is 7.8e-3); lse stays f32.
TOL = {torch.float32: {"o": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"o": 2e-2, "lse": 1e-4}}
# the greedy-token check compares log-probs instead where the top-2
# margin is below this
MARGIN_TOL = 1e-3

KERNEL_ROW = {"name": "flash_attention_fwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/flash_attention_fwd.cu",
              "replaces": "bigdl_tpu/ops/attention_kernel.py:186"}
BN_FWD_ROW = {"name": "bn_relu_fwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/bn_relu_fwd.cu",
              "replaces": "bigdl_tpu/ops/bn_relu_kernel.py:75"}
BN_BWD_ROW = {"name": "bn_relu_bwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/bn_relu_bwd.cu",
              "replaces": "bigdl_tpu/ops/bn_relu_kernel.py:118"}
DQ_ROW = {"name": "flash_attention_bwd_dq", "route": "cuda",
          "source": "bigdl_tpu_torch/csrc/flash_attention_bwd_dq.cu",
          "replaces": "bigdl_tpu/ops/attention_kernel.py:425"}
CARRY_ROW = {"name": "flash_attention_carry", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_attention_carry.cu",
             "replaces": "bigdl_tpu/ops/attention_kernel.py:277"}
DKV_ROW = {"name": "flash_attention_bwd_dkv", "route": "cuda",
           "source": "bigdl_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
           "replaces": "bigdl_tpu/ops/attention_kernel.py:469"}
# flash backward, per element and gradient: |kernel - plain| <=
# BWD_RTOL * |plain| + BWD_ATOL * max|plain|. Both sum the same f32 terms
# in another order (~2e-6 * max|plain| apart at T=2048); in bf16 each
# also rounds the gradient to nearest, which puts them at most one ulp,
# 2**-7 * |plain|, apart. That is tighter everywhere than 2e-2 * max|plain|.
BWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
BWD_ATOL = 1e-4
# which design of kernels 1-4 a dtype runs (the .cu files' entry points
# dispatch by dtype): bf16 on the tensor cores, f32 on the CUDA cores.
# Kernel 5 picks by its dtypes and width (`stem_design`).
DESIGN = {torch.float32: "cuda_cores_f32", torch.bfloat16: "tensor_cores"}
# kernels 6-7, memory-bound on the CUDA cores in every dtype: a thread owns
# 8 columns (16-byte accesses), the grid fills the SMs (forward) or is
# (row tiles x column groups) with dscale/dshift finished in the launch
# by the last tile (backward); x read in its own dtype, g with its row
# stride
BN_DESIGN = {"bn_relu_fwd": "cuda_cores_octets_sm_filled",
             "bn_relu_bwd": "cuda_cores_octets_2d_grid_one_launch"}
# the kernels with a bf16 tensor-core design beside a CUDA-core one
TC_KERNELS = ("flash_attention_fwd", "flash_attention_carry",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "stem_conv")
# the LM: kernel launches of each of kernels 1, 3 and 4 a training step
LM_LAYERS = 4
# dscale/dshift: kernel and plain sum the same f32 terms in another order;
# the limit per channel is this times the sum of the terms' magnitudes
BN_SUM_RTOL = 1e-5
# ResNet-50: the stem's BN and bn1/bn2 of each of the 16 bottlenecks
BN_SITES = 33
# ResNet-50 b128's eight distinct fused sites: (N, C) of the [N, C] view
# and the launches a step of each (33 in all)
RESNET_BN_SITES = [(128 * 112 * 112, 64, 1), (128 * 56 * 56, 64, 6),
                   (128 * 56 * 56, 128, 1), (128 * 28 * 28, 128, 7),
                   (128 * 28 * 28, 256, 1), (128 * 14 * 14, 256, 11),
                   (128 * 14 * 14, 512, 1), (128 * 7 * 7, 512, 5)]
# f32 kernel-vs-twin losses after 3 steps: the twin differs only in the
# summation order of dscale/dshift (~1e-7 relative a step)
PARITY_RTOL = 1e-4
# kernel 2 against its plain version: acc within CARRY_TOL * max|plain|,
# m and l within CARRY_TOL * max(|plain|, 1) per element. In f32 both sum
# the same f32 terms in another order. In bf16 both take S as exact
# products summed in f32; the kernel's P V carries P as bf16 hi + lo
# (~2**-17 of P), 0.12-0.19 of this limit in a CPU emulation
# (tests/test_torch_attention_kernel.py). A wrong map or guard is off by
# far more.
CARRY_TOL = 1e-5
# sequence parallelism at full width against kernel 1 on the whole
# sequence, per element: one bf16 ulp of |ref| plus SP_ATOL * max|ref|;
# gradients (f32): SP_GRAD_ATOL * max|ref|
SP_ATOL = 1e-4
SP_GRAD_ATOL = 1e-4
STEM_ROW = {"name": "stem_conv", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/stem_conv.cu",
            "replaces": "bigdl_tpu/ops/stem_kernel.py:61"}
# the stem kernel against its plain version, per element: STEM_ATOL *
# max|plain|, plus one bf16 ulp (2**-7 * |plain|) in bf16. Both sum the
# same f32 products (k*k*C_in of them) in another order, ~1e-7 apart; a
# wrong tap, pad or guard is off by far more.
STEM_ATOL = 1e-5
# served ResNet-50 rows against the cuDNN-stem twin, per element:
# SERVE_ATOL * max|twin row| (the stem's f32 sums in another order,
# carried through 53 layers); the argmax must agree wherever the twin's
# top-2 margin exceeds MARGIN_TOL
SERVE_ATOL = 1e-4
STEM_ENV = "BIGDL_TPU_PALLAS_STEM"
# the served configuration: images, engine batch, burst size, closed-loop
# clients x requests each
SERVE_HW = 224
SERVE_BATCH = 32
SERVE_BURST = 96
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters):
    """Mean device time of `fn()` over `iters` back-to-back calls, after
    three warm-up calls, from CUDA events."""
    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def unmasked_pairs(tq, tk, causal, q_offset, k_offset):
    """(query, key) pairs that attention computes for these inputs."""
    if not causal:
        return tq * tk
    rows = np.arange(tq) + q_offset - k_offset + 1
    return int(np.clip(rows, 0, tk).sum())


def roofline(flops, nbytes, dtype):
    """(least ms, what bounds it) for `flops` operations in `dtype` and
    `nbytes` moved, at the card's published peaks."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, tq, tk, d, causal, q_offset, k_offset, dtype):
    """Least time (ms) the card could take for this call, and what bounds
    it: q, k, v read once, O and lse written once; 4*D operations per
    unmasked (query, key) pair (QK^T and PV), counted for these inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * d * (2 * tq + 2 * tk) * elem + b * h * tq * 4
    return roofline(4.0 * b * h * d * pairs, nbytes, dtype)


def attention_bwd_bound(kernel, b, h, tq, tk, d, causal, q_offset, k_offset,
                        dtype):
    """Least time (ms) of one backward kernel, and what bounds it. dq:
    q, dO, k, v, lse, delta read once, dq written once; 3 products (S, dP,
    dQ). dk/dv: q, dO, k, v, lse, delta read once, dk, dv written once; 4
    products (S, dP, dV, dK). 2*D operations per unmasked pair a product,
    counted for these inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    rows = 2 * b * h * tq * 4  # lse and delta, f32
    if kernel == "dq":
        products, nbytes = 3, b * h * d * (3 * tq + 2 * tk) * elem + rows
    else:
        products, nbytes = 4, b * h * d * (2 * tq + 4 * tk) * elem + rows
    return roofline(2.0 * products * b * h * d * pairs, nbytes, dtype)


def bwd_error(got, ref, dtype):
    """(max |got - ref|, the largest share of its per-element limit) of a
    flash backward gradient against its plain version."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    lim = BWD_RTOL[dtype] * ref.abs() + BWD_ATOL * ref.abs().max()
    return float(err.max()), float((err / lim).max())


def _offset_view(x):
    """x's values in a contiguous view that starts 2 bytes past a 16-byte
    boundary (a bf16 buffer one element longer)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    out = buf[1:].view(x.shape)
    check(out.data_ptr() % 16 == 2, "the offset view is not 2 bytes past "
                                    "a 16-byte boundary")
    return out


def kernel_phase(ak):
    """Kernel vs plain version at the prefill shapes (B=4, H=8, D=64) and
    a few edge cases, each in f32 (the CUDA-core design) and bf16 (the
    tensor-core design), and bf16 inputs 2 bytes past a 16-byte boundary
    (the element-copy path: the same bits as the aligned inputs). Every
    case also launches twice and wants the same bits. Returns the row for
    the main-path shape."""
    shapes = [  # name, b, h, tq, tk, d, causal, q_off, k_off
        ("causal T=128", 4, 8, 128, 128, 64, True, 0, 0),
        ("causal T=1000 (ragged)", 4, 8, 1000, 1000, 64, True, 0, 0),
        ("causal T=2048", 4, 8, 2048, 2048, 64, True, 0, 0),
        ("non-causal Tq=1000 Tk=1500 (ragged)", 4, 8, 1000, 1500, 64, False,
         0, 0),
        ("causal k_offset=64: rows 0-63 fully masked", 2, 4, 128, 128, 64,
         True, 0, 64),
        ("causal T=512 D=128", 2, 8, 512, 512, 128, True, 0, 0),
        ("non-causal T=300 D=40", 2, 4, 300, 300, 40, False, 0, 0),
    ]
    cases = [  # name, b, h, tq, tk, d, causal, q_off, k_off, dtype, offset
        (name + (" bf16" if dtype == torch.bfloat16 else ""), *shape, dtype,
         False)
        for dtype in (torch.float32, torch.bfloat16)
        for name, *shape in shapes]
    cases += [("causal T=1000 bf16, inputs 2 bytes past 16-byte alignment",
               4, 8, 1000, 1000, 64, True, 0, 0, torch.bfloat16, True),
              ("non-causal T=300 D=40 bf16, inputs 2 bytes past 16-byte "
               "alignment", 2, 4, 300, 300, 40, False, 0, 0, torch.bfloat16,
               True)]
    main_row = None
    for (name, b, h, tq, tk, d, causal, q_off, k_off, dtype,
         offset) in cases:
        # the same seed for a shape in every dtype and alignment
        gen = torch.Generator(device="cuda").manual_seed(tq * 7 + tk + d)
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda"
                        ).to(dtype)
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        aligned = None
        with torch.inference_mode():
            if offset:
                aligned = ak.flash_attention_forward(q, k, v,
                                                     return_lse=True, **kw)
                q, k, v = (_offset_view(x) for x in (q, k, v))
            o, lse = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                **kw)
            o2, lse2 = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                  **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = ak.flash_attention_forward_plain(q, k, v, **kw)
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite kernel output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        tol = TOL[dtype]
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        ok = err_o <= tol["o"] and err_lse <= tol["lse"] and bitwise
        if aligned is not None:
            ok = ok and torch.equal(o, aligned[0]) \
                and torch.equal(lse, aligned[1])
        if k_off > q_off:
            dead = k_off - q_off
            ok = ok and bool((o[:, :, :dead] == 0).all()
                             and (lse[:, :, :dead] == 0).all())
        iters = 20 if tq * tk >= 1 << 20 else 50
        with torch.inference_mode():
            ms = cuda_ms(lambda: ak.flash_attention_forward(
                q, k, v, return_lse=True, **kw), iters)
            plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
                q, k, v, **kw), iters)
            library_ms = None
            if q_off == k_off == 0:
                library_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal), iters)
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                             q_off, k_off, dtype)
        row = {"case": name, "shape": [b, h, tq, tk, d],
               "dtype": str(dtype).replace("torch.", ""),
               "design": DESIGN[dtype],
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": tol["o"], "tol_lse": tol["lse"],
               "bitwise_repeat": bitwise,
               "equal_to_aligned": None if aligned is None else bool(
                   torch.equal(o, aligned[0])
                   and torch.equal(lse, aligned[1])),
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms}
        print("kernel case " + json.dumps(row), flush=True)
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(O {err_o:.3e} > {tol['o']} or lse {err_lse:.3e} > "
                  f"{tol['lse']}), a second launch or the aligned inputs "
                  "give other bits, or a fully masked row is not 0")
        if name == "causal T=2048":
            main_row = {"max_abs_err": err_o, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "design": DESIGN[dtype]}
        del q, k, v, o, o2, lse, lse2, o_ref, lse_ref, aligned
    torch.cuda.empty_cache()
    return main_row


def check_tokens(model, twin, prompt, got, greedy_decode_reference):
    """The engine's greedy tokens against the full-recompute reference on
    the twin without the kernel. At a step whose reference top-2 margin is
    below MARGIN_TOL the two paths may rightly pick different tokens:
    there the two models' log-probs are compared instead, and the check
    stops (the trajectories may part after a near tie)."""
    ref = greedy_decode_reference(twin, prompt, len(got))
    for i, (a, r) in enumerate(zip(got, ref)):
        if a == r:
            continue
        prefix = torch.tensor(np.concatenate([prompt, got[:i]])[None],
                              device="cuda")
        with torch.inference_mode():
            lp_ref = twin(prefix)[0, -1]
            lp_got = model(prefix)[0, -1]
        top2 = lp_ref.topk(2).values
        margin = float(top2[0] - top2[1])
        err = float((lp_got - lp_ref).abs().max())
        check(margin < MARGIN_TOL and err < MARGIN_TOL,
              f"prompt of {prompt.size}: token {i} is {a}, reference {r} "
              f"(top-2 margin {margin:.2e}, log-prob error {err:.2e})")
        print(f"prompt of {prompt.size}: near tie at token {i} (margin "
              f"{margin:.2e}); log-probs agree to {err:.2e}", flush=True)
        return i
    return len(got)


def generation_phase(ak):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (GenerationEngine,
                                         greedy_decode_reference)

    cfg = dict(vocab_size=1024, embed_dim=512, n_layer=4, n_head=8)
    model = TransformerLM(**cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    twin = TransformerLM(**cfg, use_flash=False, device="cuda")
    twin.load_state_dict(model.state_dict())
    n_new = 32
    lengths = [3, 9, 17, 40, 100, 250, 500, 900, 1300, 1900]
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg["vocab_size"] + 1, size=n).astype(np.int32)
               for n in lengths]
    results = [None] * len(prompts)
    with GenerationEngine(model, slots=8, max_len=2048, prefill_batch=4,
                          max_new_tokens=n_new, device="cuda") as eng:
        t0 = time.perf_counter()
        shapes = eng.warmup()
        torch.cuda.synchronize()
        print(f"warmup: {shapes} shapes in {time.perf_counter() - t0:.2f} s",
              flush=True)

        def client(i):
            s = eng.generate(prompts[i], max_new_tokens=n_new)
            toks = []
            try:
                toks = s.result(timeout=600)
            except Exception as e:  # reported below with the stream status
                print(f"request {i}: {e!r}", file=sys.stderr)
            results[i] = (s.status, len(toks), toks)

        # the main path's run: counts start at 0 here and are read after
        ak.flash_attention_forward.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = ak.flash_attention_forward.launches
        stats = eng.generation_stats()
    for i, r in enumerate(results):
        check(r is not None and r[0] == "ok" and r[1] == n_new,
              f"request {i} (prompt {lengths[i]}): {r and r[:2]}")
    check(launches == stats["prefill_batches"] * cfg["n_layer"] > 0,
          f"flash kernel launches {launches} != prefill batches "
          f"{stats['prefill_batches']} x {cfg['n_layer']} layers")
    tokens = sum(r[1] for r in results)
    gen = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
           "tokens_per_sec": tokens / wall,
           "prefill_batches": stats["prefill_batches"],
           "prefill_ms_per_batch":
               1e3 * stats["prefill_s_total"] / stats["prefill_batches"],
           "decode_steps": stats["decode_steps"],
           "decode_ms_per_step":
               1e3 * stats["decode_s_total"] / stats["decode_steps"],
           "decode_occupancy": stats["decode_occupancy"],
           "kernel_launches": launches}
    print("generation " + json.dumps(gen), flush=True)

    for i in (0, len(prompts) - 1):  # shortest and longest prompt
        n = check_tokens(model, twin, prompts[i], results[i][2],
                         greedy_decode_reference)
        print(f"prompt of {lengths[i]}: {n}/{n_new} tokens equal the "
              "reference", flush=True)
    return launches


def bn_relu_bound(n, c, x_dtype, y_dtype, backward):
    """Least time (ms) for one call and what bounds it. Forward: x read,
    y written, scale/shift read; 3 f32 operations an element (multiply,
    add, max). Backward: x and g read, dx written, scale/shift read,
    dscale/dshift written; 7 f32 operations an element (the recomputed
    multiply-add, the mask, dx, and the two sums)."""
    xe = torch.tensor([], dtype=x_dtype).element_size()
    ye = torch.tensor([], dtype=y_dtype).element_size()
    if backward:
        nbytes, ops = n * c * (xe + ye + 4) + 4 * c * 4, 7.0 * n * c
    else:
        nbytes, ops = n * c * (xe + ye) + 2 * c * 4, 3.0 * n * c
    t_ops = ops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


BN_SHAPES = [("7x5", 7, 5), ("1x129", 1, 129), ("16x130", 16, 130),
             ("stem", 128 * 112 * 112, 64),
             ("last stage", 128 * 7 * 7, 512)]
BN_DTYPES = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16)]


def bn_relu_phase(bk, shapes=BN_SHAPES, dtypes=BN_DTYPES, main="stem"):
    """Both BN+ReLU kernels against their plain versions. Returns the rows
    for the main path's site `main` with the ReLU: "fwd" and "bwd" with x,
    y and g bf16 (the main path's dtypes), "fwd_x_f32" and "bwd_x_f32"
    with x f32, where `dtypes` has them."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, n, c in shapes:
        x32 = torch.randn((n, c), generator=gen, device="cuda")
        scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((c,), generator=gen, device="cuda") * 0.5
        g32 = torch.randn((n, c), generator=gen, device="cuda")
        for x_dt, y_dt in dtypes:
            x, g = x32.to(x_dt), g32.to(y_dt)
            for relu in (True, False):
                name = (f"{label} [{n}x{c}] x {str(x_dt)[6:]} y "
                        f"{str(y_dt)[6:]} relu={relu}")
                y = bk.bn_relu_forward(x, scale, shift, relu, y_dt)
                dx, ds, db = bk.bn_relu_backward(x, scale, shift, g, relu)
                _, ds2, db2 = bk.bn_relu_backward(x, scale, shift, g, relu)
                torch.cuda.synchronize()
                again = torch.equal(ds, ds2) and torch.equal(db, db2)
                bwd_k = device_profile(lambda: bk.bn_relu_backward(
                    x, scale, shift, g, relu), reps=5)[1]
                y_ref = bk.bn_relu_forward_plain(x, scale, shift, relu, y_dt)
                dx_ref, ds_ref, db_ref = bk.bn_relu_backward_plain(
                    x, scale, shift, g, relu)
                gm = g.float()
                if relu:
                    pre = (x * scale + shift).to(y_dt)
                    gm = torch.where(pre > 0, gm, 0.0)
                lim_ds = BN_SUM_RTOL * (gm * x.float()).abs().sum(0)
                lim_db = BN_SUM_RTOL * gm.abs().sum(0)
                err_y = float((y.float() - y_ref.float()).abs().max())
                err_dx = float((dx - dx_ref).abs().max())
                ok = (y.dtype == y_dt and torch.equal(y, y_ref)
                      and torch.equal(dx, dx_ref)
                      and bool(((ds - ds_ref).abs() <= lim_ds).all())
                      and bool(((db - db_ref).abs() <= lim_db).all()))
                iters = 20 if n * c > 1 << 22 else 50
                fwd_ms = cuda_ms(lambda: bk.bn_relu_forward(
                    x, scale, shift, relu, y_dt), iters)
                fwd_plain_ms = cuda_ms(lambda: bk.bn_relu_forward_plain(
                    x, scale, shift, relu, y_dt), iters)
                bwd_ms = cuda_ms(lambda: bk.bn_relu_backward(
                    x, scale, shift, g, relu), iters)
                bwd_plain_ms = cuda_ms(lambda: bk.bn_relu_backward_plain(
                    x, scale, shift, g, relu), iters)
                fwd_bound = bn_relu_bound(n, c, x_dt, y_dt, False)
                bwd_bound = bn_relu_bound(n, c, x_dt, y_dt, True)
                row = {"case": name, "ok": ok, "second_launch_equal": again,
                       "bwd_kernels_per_call": bwd_k,
                       "max_abs_err_y": err_y,
                       "max_abs_err_dx": err_dx,
                       "max_abs_err_dscale": float((ds - ds_ref).abs().max()),
                       "max_abs_err_dshift": float((db - db_ref).abs().max()),
                       "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
                       "fwd_bound_ms": fwd_bound[0],
                       "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
                       "bwd_bound_ms": bwd_bound[0],
                       "fwd_share_of_bound": fwd_bound[0] / fwd_ms,
                       "bwd_share_of_bound": bwd_bound[0] / bwd_ms}
                print("bn_relu case " + json.dumps(row), flush=True)
                check(ok, f"{name}: a BN+ReLU kernel disagrees with its "
                          f"plain version (y {err_y:.3e}, dx {err_dx:.3e}, "
                          "or dscale/dshift beyond "
                          f"{BN_SUM_RTOL} * sum|terms|)")
                check(again and bwd_k == 1,
                      f"{name}: a second backward launch gave other "
                      f"dscale/dshift bits ({again}) or the backward took "
                      f"{bwd_k} device kernels a call")
                if label == main and y_dt == torch.bfloat16 and relu:
                    tag = "" if x_dt == torch.bfloat16 else "_x_f32"
                    rows["fwd" + tag] = {
                        "max_abs_err": err_y, "ms": fwd_ms,
                        "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0],
                        "bound_by": fwd_bound[1], "library_ms": None}
                    rows["bwd" + tag] = {
                        "max_abs_err": err_dx, "ms": bwd_ms,
                        "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0],
                        "bound_by": bwd_bound[1], "library_ms": None}
        del x32, g32, x, g
    return rows


def bn_sites_phase(bk):
    """5(b): kernels 6-7 at each of ResNet-50 b128's eight distinct sites
    with x, y and g bf16 (the main path's dtypes): y and dx bitwise
    against the plain versions, dscale/dshift within BN_SUM_RTOL, a second
    backward launch bitwise equal, exactly one device kernel a backward
    call, and the device times (the profiler) and CUDA-event times beside
    the bounds. Returns the sites' rows and the step's sums."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    sites = []
    step = {"fwd_device_ms": 0.0, "bwd_device_ms": 0.0, "fwd_bound_ms": 0.0,
            "bwd_bound_ms": 0.0, "launches": 0}
    for n, c, per_step in RESNET_BN_SITES:
        x = torch.randn((n, c), generator=gen, device="cuda").to(bf)
        scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((c,), generator=gen, device="cuda") * 0.5
        g = torch.randn((n, c), generator=gen, device="cuda").to(bf)
        y = bk.bn_relu_forward(x, scale, shift, True, bf)
        dx, ds, db = bk.bn_relu_backward(x, scale, shift, g, True)
        _, ds2, db2 = bk.bn_relu_backward(x, scale, shift, g, True)
        torch.cuda.synchronize()
        y_ref = bk.bn_relu_forward_plain(x, scale, shift, True, bf)
        dx_ref, ds_ref, db_ref = bk.bn_relu_backward_plain(
            x, scale, shift, g, True)
        gm = torch.where((x * scale + shift).to(bf) > 0, g.float(), 0.0)
        ok = (torch.equal(y, y_ref) and torch.equal(dx, dx_ref)
              and bool(((ds - ds_ref).abs() <= BN_SUM_RTOL
                        * (gm * x.float()).abs().sum(0)).all())
              and bool(((db - db_ref).abs()
                        <= BN_SUM_RTOL * gm.abs().sum(0)).all()))
        again = torch.equal(ds, ds2) and torch.equal(db, db2)
        del y_ref, dx_ref, gm, dx
        iters = 20 if n * c > 1 << 22 else 50
        fwd_dev, fwd_k = device_profile(lambda: bk.bn_relu_forward(
            x, scale, shift, True, bf))
        bwd_dev, bwd_k = device_profile(lambda: bk.bn_relu_backward(
            x, scale, shift, g, True))
        fwd_bound = bn_relu_bound(n, c, bf, bf, False)
        bwd_bound = bn_relu_bound(n, c, bf, bf, True)
        part = bk.bwd_partition(n, c)
        row = {"site": [n, c], "launches_per_step": per_step, "ok": ok,
               "second_launch_equal": again,
               "bwd_partition": part._asdict(),
               "fwd_kernels_per_call": fwd_k, "bwd_kernels_per_call": bwd_k,
               "fwd_device_ms": fwd_dev, "fwd_ms": cuda_ms(
                   lambda: bk.bn_relu_forward(x, scale, shift, True, bf),
                   iters),
               "fwd_bound_ms": fwd_bound[0],
               "fwd_share_of_bound": fwd_bound[0] / fwd_dev,
               "bwd_device_ms": bwd_dev, "bwd_ms": cuda_ms(
                   lambda: bk.bn_relu_backward(x, scale, shift, g, True),
                   iters),
               "bwd_bound_ms": bwd_bound[0],
               "bwd_share_of_bound": bwd_bound[0] / bwd_dev,
               "max_abs_err_dscale": float((ds - ds_ref).abs().max()),
               "max_abs_err_dshift": float((db - db_ref).abs().max())}
        print("bn_relu site " + json.dumps(row), flush=True)
        check(ok, f"site [{n}, {c}]: a BN+ReLU kernel disagrees with its "
                  "plain version")
        check(again, f"site [{n}, {c}]: a second backward launch gave "
                     "other dscale/dshift bits")
        check(fwd_k == 1 and bwd_k == 1,
              f"site [{n}, {c}]: {fwd_k} forward and {bwd_k} backward "
              "device kernels a call, not one each")
        for k in ("fwd_device_ms", "bwd_device_ms", "fwd_bound_ms",
                  "bwd_bound_ms"):
            step[k] += per_step * row[k]
        step["launches"] += per_step
        sites.append(row)
        del x, g
    torch.cuda.empty_cache()
    check(step["launches"] == BN_SITES, f"{step['launches']} site launches")
    step["fwd_share_of_bound"] = step["fwd_bound_ms"] / step["fwd_device_ms"]
    step["bwd_share_of_bound"] = step["bwd_bound_ms"] / step["bwd_device_ms"]
    print("bn_relu resnet50 step " + json.dumps(step), flush=True)
    return {"sites": sites, "step": step}


def _reset_bn_counts(bk):
    bk.bn_relu_forward.launches = 0
    bk.bn_relu_backward.launches = 0
    bk.BnReluFunction.g_copies = 0


def training_phase(bk):
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion, fusion_scope
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools.bench import bench_resnet50

    # f32 parity: the model against a twin without the kernel
    torch.backends.cudnn.deterministic = True
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy((rs.randint(0, 1000, size=8) + 1).astype(np.int32))
    batch = MiniBatch(x.cuda(), y.cuda())
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    twin = ResNet50(class_num=1000, s2d_stem=True, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]), ClassNLLCriterion(),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    _reset_bn_counts(bk)
    got = train3(model)
    launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    with fusion_scope(False):
        ref = train3(twin)
    twin_launches = (bk.bn_relu_forward.launches,
                     bk.bn_relu_backward.launches)
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("training parity " + json.dumps({
        "batch": batch.size(), "steps": 3, "dtype": "float32", "losses": got,
        "twin_losses": ref, "rel_diff": rel, "launches": launches}),
        flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"f32 losses {got} vs twin {ref}: relative {max(rel):.2e} > "
          f"{PARITY_RTOL}")
    check(launches == (3 * BN_SITES, 3 * BN_SITES),
          f"BN+ReLU launches {launches} != {3 * BN_SITES} each in 3 steps")
    check(twin_launches == launches, "the twin without fusion launched a "
                                     "BN+ReLU kernel")
    del model, twin, batch
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # the benchmark configuration: the main path's run
    warmup, iters, sync = 8, 24, 8
    torch.cuda.reset_peak_memory_stats()
    _reset_bn_counts(bk)
    res = bench_resnet50(batch_size=128, warmup=warmup, iters=iters,
                         sync=sync, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    steps = warmup + iters
    launches = {"bn_relu_fwd": bk.bn_relu_forward.launches,
                "bn_relu_bwd": bk.bn_relu_backward.launches}
    g_copies = bk.BnReluFunction.g_copies
    losses = res["losses"]
    out = {k: res[k] for k in ("imgs_per_sec", "ms_per_step", "batch_size",
                               "steps", "warmup", "sync", "device")}
    out.update({"precision": "bfloat16 compute, f32 masters",
                "loss_first": losses[0], "loss_last": losses[-1],
                "launches": launches, "launches_per_step": {
                    k: v / steps for k, v in launches.items()},
                "g_copies_per_step": g_copies / steps,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print("training " + json.dumps(out), flush=True)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"non-finite or missing losses: {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    for k, v in launches.items():
        check(v == BN_SITES * steps,
              f"{k} launched {v} times in {steps} steps, not "
              f"{BN_SITES} x {steps}")
    return launches, res


def _kernel_label(mangled):
    """"tensor_cores DMAX=64", "cuda_cores_f32 KT=4 x=f32 w=bf16" and the
    like, from a kernel's mangled name: `_tc_kernel` is a bf16
    tensor-core design; the flash kernels take DMAX, the stem kernels KT
    (and the CUDA-core stem kernels x's and wk's types)."""
    m = re.search(r"kernelI(\w*?)Li(\d+)E", mangled)
    if not m:
        return mangled
    design = "tensor_cores" if "_tc_kernel" in mangled else "cuda_cores_f32"
    label = f"{design} {'KT' if 'stem' in mangled else 'DMAX'}={m[2]}"
    types = []
    for tok in re.findall(r"13__nv_bfloat16|f|S\d*_", m[1]):
        # S<n>_ names a type seen before: here always the previous one
        types.append(types[-1] if tok.startswith("S") else
                     "f32" if tok == "f" else "bf16")
    if len(types) == 2:
        label += f" x={types[0]} w={types[1]}"
    return label


def build_report(_build, name):
    """Per kernel of library `name`: ptxas's registers and spill bytes
    (nvcc -Xptxas -v) and the HMMA instructions in its SASS
    (cuobjdump -sass)."""
    out, label = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            label = _kernel_label(m.group(1))
            out.setdefault(label, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and label:
            out[label].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            out[label]["registers"] = int(m[1])
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.build_kernels([name])[0])],
        capture_output=True, text=True, timeout=120, check=True).stdout
    label = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            label = _kernel_label(m.group(1))
            out.setdefault(label, {})["hmma"] = 0
        elif label and re.search(r"\bHMMA\b", line):
            out[label]["hmma"] += 1
    return out


def build_phase(_build):
    """The bf16 designs of kernels 1-5 run on the tensor cores
    (HMMA in their SASS) and spill nothing at the main paths' widths
    (D <= 64; the stem's KT = 4); the CUDA-core designs have no HMMA."""
    report = {name: build_report(_build, name) for name in TC_KERNELS}
    print("tensor-core kernels build " + json.dumps(report), flush=True)
    for name, kernels in report.items():
        key, sizes, main = (("KT", (2, 4, 6), 4) if name == "stem_conv"
                            else ("DMAX", (64, 128), 64))
        for size in sizes:
            tc = kernels.get(f"tensor_cores {key}={size}", {})
            check(tc.get("hmma", 0) > 0,
                  f"{name}: no HMMA instruction in the bf16 kernel at "
                  f"{key} {size}: {tc}")
        tc = kernels[f"tensor_cores {key}={main}"]
        check(tc.get("spill_stores") == tc.get("spill_loads") == 0,
              f"{name}: the bf16 kernel at {key} {main} spills: {tc}")
        for label, k in kernels.items():
            check(not label.startswith("cuda_cores") or k.get("hmma") == 0,
                  f"{name}: the CUDA-core kernel {label} has HMMA: {k}")
    return report


def flash_backward_phase(ak):
    """Kernels 3 and 4 against their plain versions, and kernel 1 (whose O
    and lse they take) against its own. Returns the rows for the main
    path's shape (the LM's attention: B=8, H=8, T=2048, D=64, causal, bf16)
    and kernel 1's error and time there."""
    shapes = [  # name, b, h, tq, tk, d, causal, q_off, k_off
        ("causal T=1000 (ragged)", 4, 8, 1000, 1000, 64, True, 0, 0),
        ("non-causal Tq=1000 Tk=1500 (ragged)", 4, 8, 1000, 1500, 64, False,
         0, 0),
        ("causal T=512 D=128", 2, 8, 512, 512, 128, True, 0, 0),
        ("causal q_offset=-64: rows 0-63 fully masked", 2, 4, 256, 256, 64,
         True, -64, 0),
    ]
    cases = [  # name, b, h, tq, tk, d, causal, q_off, k_off, dtype
        ("causal T=2048", 8, 8, 2048, 2048, 64, True, 0, 0, torch.float32),
        ("causal T=2048 bf16 (training shape)", 8, 8, 2048, 2048, 64, True,
         0, 0, torch.bfloat16),
        *((name + (" bf16" if dtype == torch.bfloat16 else ""), *shape,
           dtype)
          for dtype in (torch.float32, torch.bfloat16)
          for name, *shape in shapes),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = None
    for (name, b, h, tq, tk, d, causal, q_off, k_off, dtype) in cases:
        q, do = (torch.randn((b, h, tq, d), generator=gen, device="cuda"
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        with torch.inference_mode():
            o, lse = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                **kw)
            delta = ak.attention_delta(o, do)
            args = (q, k, v, do, lse, delta)
            dq = ak.flash_attention_backward_dq(*args, **kw)
            dk, dv = ak.flash_attention_backward_dkv(*args, **kw)
            torch.cuda.synchronize()
            dq2 = ak.flash_attention_backward_dq(*args, **kw)
            dk2, dv2 = ak.flash_attention_backward_dkv(*args, **kw)
            sm = d ** -0.5
            pargs = (*args, causal, sm, q_off, k_off)
            ref_dq = ak.flash_attention_backward_dq_plain(*pargs)
            ref_dk, ref_dv = ak.flash_attention_backward_dkv_plain(*pargs)
            o_ref, lse_ref = ak.flash_attention_forward_plain(q, k, v, **kw)
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite kernel 1 output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        fwd_ok = err_o <= TOL[dtype]["o"] and err_lse <= TOL[dtype]["lse"]
        errs, shares = {}, {}
        for key, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                              ("dv", dv, ref_dv)):
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"{name}: {key} is not finite {dtype}")
            errs[key], shares[key] = bwd_error(got, ref, dtype)
        bitwise = (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                   and torch.equal(dv, dv2))
        ok = fwd_ok and bitwise and all(v <= 1 for v in shares.values())
        if k_off > q_off:
            ok = ok and bool((dq[:, :, :k_off - q_off] == 0).all())
        iters = 10 if tq * tk >= 1 << 20 else 30
        with torch.inference_mode():
            dq_ms = cuda_ms(lambda: ak.flash_attention_backward_dq(
                *args, **kw), iters)
            dkv_ms = cuda_ms(lambda: ak.flash_attention_backward_dkv(
                *args, **kw), iters)
            bwd_ms = cuda_ms(lambda: ak.flash_attention_backward(
                q, k, v, o, lse, do, **kw), iters)
            dq_plain_ms = cuda_ms(
                lambda: ak.flash_attention_backward_dq_plain(*pargs), iters)
            dkv_plain_ms = cuda_ms(
                lambda: ak.flash_attention_backward_dkv_plain(*pargs), iters)
            fwd_ms = cuda_ms(lambda: ak.flash_attention_forward(
                q, k, v, return_lse=True, **kw), iters)
            fwd_plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
                q, k, v, **kw), iters)
        library_ms = fwd_library_ms = None
        if q_off == k_off == 0:  # SDPA's backward, the yardstick for 3+4
            qg, kg, vg = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), iters)
            del out, qg, kg, vg
            with torch.inference_mode():  # and its forward, for kernel 1
                fwd_library_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal), iters)
        dq_bound = attention_bwd_bound("dq", b, h, tq, tk, d, causal, q_off,
                                       k_off, dtype)
        dkv_bound = attention_bwd_bound("dkv", b, h, tq, tk, d, causal,
                                        q_off, k_off, dtype)
        fwd_bound = attention_bound(b, h, tq, tk, d, causal, q_off, k_off,
                                    dtype)
        row = {"case": name, "shape": [b, h, tq, tk, d],
               "dtype": str(dtype).replace("torch.", ""),
               "design": DESIGN[dtype], "ok": ok,
               "fwd_max_abs_err_o": err_o, "fwd_max_abs_err_lse": err_lse,
               "fwd_tol_o": TOL[dtype]["o"], "fwd_tol_lse": TOL[dtype]["lse"],
               "bitwise_repeat": bitwise, "max_abs_err": errs,
               "max_share_of_limit": shares, "rtol": BWD_RTOL[dtype],
               "atol_of_max": BWD_ATOL, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
               "backward_ms": bwd_ms, "dq_plain_ms": dq_plain_ms,
               "dkv_plain_ms": dkv_plain_ms,
               "sdpa_backward_ms": library_ms,
               "dq_bound_ms": dq_bound[0], "dkv_bound_ms": dkv_bound[0],
               "dq_share_of_bound": dq_bound[0] / dq_ms,
               "dkv_share_of_bound": dkv_bound[0] / dkv_ms,
               "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
               "fwd_bound_ms": fwd_bound[0],
               "sdpa_forward_ms": fwd_library_ms}
        print("flash backward case " + json.dumps(row), flush=True)
        check(ok, f"{name}: kernel 1 disagrees with its plain version (O "
                  f"{err_o:.3e} > {TOL[dtype]['o']} or lse {err_lse:.3e} > "
                  f"{TOL[dtype]['lse']}), a flash backward kernel disagrees "
                  f"with its plain version (share of the per-element limit "
                  f"{shares} > 1), is not bitwise repeatable, or a fully "
                  "masked row's dq is not 0")
        if dtype == torch.bfloat16 and tq == 2048:
            lib = {"library_ms": library_ms,
                   "library_call": "scaled_dot_product_attention backward "
                                   "(dq, dk, dv together)",
                   "backward_ms": bwd_ms}
            rows = {
                "dq": {"max_abs_err": errs["dq"], "ms": dq_ms,
                       "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                       "bound_by": dq_bound[1], **lib},
                "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                        "ms": dkv_ms, "plain_ms": dkv_plain_ms,
                        "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                        **lib},
                "fwd_training_shape": {"max_abs_err": err_o,
                                       "max_abs_err_lse": err_lse,
                                       "ms": fwd_ms,
                                       "plain_ms": fwd_plain_ms,
                                       "bound_ms": fwd_bound[0],
                                       "bound_by": fwd_bound[1],
                                       "library_ms": fwd_library_ms}}
        del q, k, v, do, o, lse, delta, args, dq, dk, dv, dq2, dk2, dv2, \
            o_ref, lse_ref
    torch.cuda.empty_cache()
    return rows


LM_CFG = dict(vocab_size=1024, embed_dim=512, n_layer=LM_LAYERS, n_head=8)


def _flash_counts(ak):
    return (ak.flash_attention_forward.launches,
            ak.flash_attention_backward_dq.launches,
            ak.flash_attention_backward_dkv.launches)


def _reset_flash_counts(ak):
    ak.flash_attention_forward.launches = 0
    ak.flash_attention_backward_dq.launches = 0
    ak.flash_attention_backward_dkv.launches = 0


def lm_training_phase(ak):
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools import transformer_lm
    from bigdl_tpu_torch.tools.bench import bench_transformer_lm

    # (a) f32 parity: the model against a twin without the kernels
    rs = np.random.RandomState(0)
    toks = rs.randint(1, LM_CFG["vocab_size"] + 1, (2, 513)).astype(np.int32)
    batch = MiniBatch(torch.from_numpy(toks[:, :-1]).cuda(),
                      torch.from_numpy(toks[:, 1:]).cuda())
    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    twin = TransformerLM(**LM_CFG, use_flash=False, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]),
                              TimeDistributedCriterion(ClassNLLCriterion(),
                                                       size_average=True),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    _reset_flash_counts(ak)
    got = train3(model)
    launches = _flash_counts(ak)
    ref = train3(twin)
    twin_launches = tuple(a - b for a, b in zip(_flash_counts(ak),
                                                launches))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("lm training parity " + json.dumps({
        "batch": 2, "seq": 512, "steps": 3, "dtype": "float32",
        "losses": got, "twin_losses": ref, "rel_diff": rel,
        "launches_fwd_dq_dkv": launches,
        "twin_launches": twin_launches}), flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"f32 LM losses {got} vs twin {ref}: relative {max(rel):.2e} > "
          f"{PARITY_RTOL}")
    check(launches == (3 * LM_LAYERS,) * 3,
          f"flash launches (fwd, dq, dkv) {launches} != {3 * LM_LAYERS} "
          "each in 3 steps")
    check(twin_launches == (0, 0, 0), "the use_flash=False twin launched a "
                                      "flash kernel")
    del model, twin, batch
    torch.cuda.empty_cache()

    # (b) the benchmark configuration: the main path's run
    warmup, iters, sync, seq = 12, 36, 12, 2048
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts(ak)
    res = bench_transformer_lm(batch_size=8, seq=seq, vocab=1024,
                               warmup=warmup, iters=iters, sync=sync,
                               device="cuda",
                               generator=torch.Generator().manual_seed(0))
    counts = _flash_counts(ak)
    steps = warmup + iters
    losses = res["losses"]
    launches = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), counts))
    out = {k: res[k] for k in ("tokens_per_sec", "ms_per_step", "batch_size",
                               "seq", "steps", "warmup", "sync", "device")}
    out.update({"precision": "bfloat16 compute, f32 masters",
                "loss_per_token_first": losses[0] / seq,
                "synced_losses": {i + 1: losses[i]
                                  for i in range(sync - 1, steps, sync)},
                "losses_every_step": losses,
                "launches": launches, "launches_per_step": {
                    k: v / steps for k, v in launches.items()},
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print("lm training " + json.dumps(out), flush=True)
    check(len(losses) == steps, f"{len(losses)} losses for {steps} steps")
    lo = math.log(LM_CFG["vocab_size"])
    check(math.isfinite(losses[0]) and lo <= losses[0] / seq <= lo + 2,
          f"first loss per token {losses[0] / seq} outside "
          f"[{lo:.3f}, {lo + 2:.3f}]")
    for k, v in launches.items():
        check(v == LM_LAYERS * steps,
              f"{k} launched {v} times in {steps} steps, not "
              f"{LM_LAYERS} x {steps}")
    lm_res = res

    # (c) the example recipe at its defaults
    t0 = time.perf_counter()
    ppl = transformer_lm.main([])
    print(f"lm example: perplexity {ppl:.3f} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(math.isfinite(ppl) and ppl < 25,
          f"the example's train-shard perplexity {ppl} is not below 25")
    return launches, lm_res


def carry_bound(b, h, tq, tk, d, causal, q_offset, k_offset, dtype):
    """Least time (ms) of one ring hop and what bounds it: q, k, v read
    once, the f32 carry (acc, m, l) read once and written once; 4*D
    operations per unmasked (query, key) pair, counted for these
    inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * d * (tq + 2 * tk) * elem \
        + 2 * b * h * tq * (d + 2) * 4
    return roofline(4.0 * b * h * d * pairs, nbytes, dtype)


def carry_error(got, want):
    """(max |acc - plain|, the largest share of the per-element limit over
    acc, m and l, and each one's share) of a carry against its plain
    version."""
    err_acc = float((got[0] - want[0]).abs().max())
    shares = {"acc": err_acc / (CARRY_TOL * float(want[0].abs().max()))}
    for name, a, b in zip("ml", got[1:], want[1:]):
        lim = CARRY_TOL * b.abs().clamp(min=1.0)
        shares[name] = float(((a - b).abs() / lim).max())
    return err_acc, max(shares.values()), shares


def _random_carry(ak, q, k0, v0, masked_rows=0):
    """A carried (acc, m, l) from the plain hop over k0, v0 (non-causal),
    with the first `masked_rows` rows still fully masked."""
    acc, m, l = ak.flash_attention_carry_plain(
        q, k0, v0, ak.attention_state_init(q))
    acc[:, :, :masked_rows] = 0
    m[:, :, :masked_rows] = ak.NEG_INF
    l[:, :, :masked_rows] = 0
    return acc, m, l


def carry_phase(ak):
    """9(a): kernel 2 against its plain version, then timed at the
    full-width hop shapes. Returns the row for the ring's below-diagonal
    hop, the hop that most of a causal ring's work runs in."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 40):
            tag = f"{str(dtype)[6:]} D={d}"
            q, k, v, k0, v0 = (rand(2, 4, 384, d, dtype=dtype)
                               for _ in range(5))
            # a two-hop continuation from a fresh state, finished, against
            # kernel 1 over the whole K/V
            with torch.inference_mode():
                state = ak.attention_state_init(q)
                shares, bitwise = [], True
                for k_off in (0, 192):
                    sl = slice(k_off, k_off + 192)
                    ks, vs = k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
                    kw = dict(causal=True, k_offset=k_off)
                    got = ak.flash_attention_carry(q, ks, vs, state, **kw)
                    again = ak.flash_attention_carry(q, ks, vs, state, **kw)
                    torch.cuda.synchronize()
                    want = ak.flash_attention_carry_plain(q, ks, vs, state,
                                                          **kw)
                    shares.append(carry_error(got, want)[1])
                    bitwise &= all(torch.equal(a, b)
                                   for a, b in zip(got, again))
                    state = got
                fin = ak.attention_state_finish(*state).to(dtype)
                o1 = ak.flash_attention_forward(q, k, v, causal=True)
            err_o = float((fin.float() - o1.float()).abs().max())
            lim_o = 1e-5 * float(o1.float().abs().max())
            if dtype == torch.bfloat16:  # both round to bf16: one ulp
                lim_o += 2 ** -7 * float(o1.float().abs().max())
            row = {"case": f"two-hop continuation {tag}",
                   "max_share_of_limit": max(shares),
                   "bitwise_repeat": bitwise,
                   "finished_vs_kernel1_max_abs_err": err_o,
                   "finished_bitwise_equal_kernel1": torch.equal(fin, o1)}
            print("carry case " + json.dumps(row), flush=True)
            check(max(shares) <= 1 and bitwise and err_o <= lim_o,
                  f"carry {tag}: continuation disagrees with its plain "
                  f"version (share {max(shares):.3f}), is not bitwise "
                  f"repeatable, or finished differs from kernel 1 by "
                  f"{err_o:.3e} > {lim_o:.3e}")

            cases = [  # name, tq, tk, causal, q_off, k_off, masked rows
                ("ragged Tq=200 Tk=136", 200, 136, True, 300, 200, 0),
                ("diagonal", 256, 256, True, 256, 256, 0),
                ("rows still fully masked", 128, 128, True, 0, 16, 32),
                ("non-causal ragged", 100, 70, False, 0, 0, 0)]
            for name, tq, tk, causal, q_off, k_off, masked in cases:
                q, k, v, k0, v0 = (rand(2, 4, t, d, dtype=dtype) for t in
                                   (tq, tk, tk, tk, tk))
                kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
                with torch.inference_mode():
                    carry = _random_carry(ak, q, k0, v0, masked)
                    got = ak.flash_attention_carry(q, k, v, carry, **kw)
                    again = ak.flash_attention_carry(q, k, v, carry, **kw)
                    torch.cuda.synchronize()
                    want = ak.flash_attention_carry_plain(q, k, v, carry,
                                                          **kw)
                err, share, _ = carry_error(got, want)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = share <= 1 and bitwise
                if masked:  # rows 0-15 see no key here either
                    ok = ok and bool((got[1][:, :, :16] == ak.NEG_INF).all()
                                     and (got[2][:, :, :16] == 0).all()
                                     and (got[0][:, :, :16] == 0).all())
                row = {"case": f"{name} {tag}", "max_abs_err_acc": err,
                       "max_share_of_limit": share,
                       "bitwise_repeat": bitwise, "ok": ok}
                print("carry case " + json.dumps(row), flush=True)
                check(ok, f"carry {name} {tag}: disagrees with its plain "
                          f"version (share {share:.3f} of the limit), is "
                          "not bitwise repeatable, or a masked row moved")

            # wholly in the past (causal equals non-causal, bitwise) and
            # wholly in the future (the carry passes through, bitwise)
            q, k, v, k0, v0 = (rand(2, 4, 192, d, dtype=dtype)
                               for _ in range(5))
            with torch.inference_mode():
                carry = _random_carry(ak, q, k0, v0)
                past = ak.flash_attention_carry(q, k, v, carry, causal=True,
                                                q_offset=192, k_offset=0)
                full = ak.flash_attention_carry(q, k, v, carry, causal=False)
                future = ak.flash_attention_carry(q, k, v, carry,
                                                  causal=True, q_offset=0,
                                                  k_offset=192)
                torch.cuda.synchronize()
            ok_past = all(torch.equal(a, b) for a, b in zip(past, full))
            ok_future = all(torch.equal(a, b) for a, b in zip(future, carry))
            print("carry case " + json.dumps({
                "case": f"past and future shards {tag}",
                "past_equals_non_causal_bitwise": ok_past,
                "future_passes_through_bitwise": ok_future}), flush=True)
            check(ok_past and ok_future,
                  f"carry {tag}: a past shard differs from causal=False or "
                  "a future shard did not pass the carry through bitwise")

    # timing at the full-width hop shapes (B1 H8 D64), bf16 (the main
    # measure) then f32 (the CUDA-core design)
    hops = [("ring below-diagonal hop", 2048, 2048, 0),
            ("ring diagonal hop", 2048, 2048, 2048),
            ("zigzag chunk (q_high vs A)", 1024, 1024 * 6, 1024)]
    main_row = None
    for dtype, name, t, q_off, k_off in [
            (dt, *hop) for dt in (torch.bfloat16, torch.float32)
            for hop in hops]:
        causal = "zigzag" not in name
        q, k, v = (rand(1, 8, t, 64, dtype=dtype)
                   for _ in range(3))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        with torch.inference_mode():
            carry = _random_carry(ak, q, *(rand(1, 8, t, 64,
                                                dtype=dtype)
                                           for _ in range(2)))
            got = ak.flash_attention_carry(q, k, v, carry, **kw)
            torch.cuda.synchronize()
            want = ak.flash_attention_carry_plain(q, k, v, carry, **kw)
            err, share, parts = carry_error(got, want)
            ms = cuda_ms(lambda: ak.flash_attention_carry(q, k, v, carry,
                                                          **kw), 20)
            plain_ms = cuda_ms(lambda: ak.flash_attention_carry_plain(
                q, k, v, carry, **kw), 20)
            k1_ms = cuda_ms(lambda: ak.flash_attention_forward(q, k, v,
                                                               **kw), 20)
        bound_ms, bound_by = carry_bound(1, 8, t, t, 64, causal, q_off,
                                         k_off, dtype)
        row = {"case": name, "shape": [1, 8, t, t, 64],
               "dtype": str(dtype).replace("torch.", ""),
               "design": DESIGN[dtype],
               "q_offset": q_off, "k_offset": k_off, "causal": causal,
               "max_abs_err": err, "max_share_of_limit": share,
               "share_of_limit": parts, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "kernel1_ms": k1_ms, "vs_kernel1": ms / k1_ms}
        print("carry timing " + json.dumps(row), flush=True)
        check(share <= 1, f"carry {name}: disagrees with its plain version "
                          f"(share {share:.3f} of the limit)")
        if dtype == torch.float32:
            main_row.setdefault("f32_hops", []).append(
                {"case": name, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "kernel1_ms": k1_ms})
        elif main_row is None:
            main_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "hop_shape": name,
                        "kernel1_ms": k1_ms}
        else:
            main_row.setdefault("other_hops", []).append(
                {"case": name, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "kernel1_ms": k1_ms})
    return main_row


def sp_mesh_devices():
    """Every card when there are two or more, else 4 shards on the one."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * 4


def sequence_parallel_phase(ak):
    """9(b) and 9(c). Returns kernel 2's launches in the full-width run
    and kernel 1's row at the long-context shape."""
    from bigdl_tpu_torch.parallel import (build_mesh,
                                          make_sequence_parallel_attention)
    devices = sp_mesh_devices()
    n = len(devices)
    mesh = build_mesh(data=n, devices=devices)
    want_launches = {"ring": n * n, "zigzag": n * (2 * n + 1), "ulysses": 0}
    fns = {s: make_sequence_parallel_attention(mesh, s, causal=True)
           for s in ("ring", "zigzag", "ulysses")}
    gen = torch.Generator(device="cuda").manual_seed(10)
    t = 8192
    q, k, v = (torch.randn((1, 8, t, 64), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        ref = ak.flash_attention_forward(q, k, v, causal=True).float()
    lim = 2 ** -7 * ref.abs() + SP_ATOL * ref.abs().max()

    # the main path's run: counts start at 0 here and are read after
    _reset_flash_counts(ak)
    ak.flash_attention_carry.launches = 0
    outs, launches = {}, {}
    with torch.inference_mode():
        for scheme, fn in fns.items():
            before = ak.flash_attention_carry.launches
            outs[scheme] = fn(q, k, v)
            torch.cuda.synchronize()
            launches[scheme] = ak.flash_attention_carry.launches - before
    total = ak.flash_attention_carry.launches
    other = _flash_counts(ak)
    check(other == (0, 0, 0), f"the sequence-parallel run launched kernels "
                              f"1, 3, 4 {other} times")
    rows = {}
    with torch.inference_mode():
        k1_ms = cuda_ms(lambda: ak.flash_attention_forward(q, k, v,
                                                           causal=True), 10)
        k1_plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
            q, k, v, causal=True), 3)
        sdpa_ms = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        is_causal=True), 10)
        for scheme, fn in fns.items():
            out = outs[scheme]
            ok_shape = out.shape == q.shape and out.dtype == q.dtype
            err = (out.float() - ref).abs()
            share = float((err / lim).max())
            rows[scheme] = {"launches": launches[scheme],
                            "max_abs_err": float(err.max()),
                            "max_share_of_limit": share,
                            "ms": cuda_ms(lambda: fn(q, k, v), 5)}
            check(ok_shape and bool(torch.isfinite(out).all()),
                  f"{scheme}: output {out.dtype} {tuple(out.shape)} is not "
                  "finite bf16 of q's shape")
            check(share <= 1, f"{scheme}: {share:.3f} of the limit from "
                              "kernel 1 over the whole sequence")
            check(launches[scheme] == want_launches[scheme],
                  f"{scheme}: kernel 2 launched {launches[scheme]} times, "
                  f"not {want_launches[scheme]}")
    k1_bound = attention_bound(1, 8, t, t, 64, True, 0, 0, torch.bfloat16)
    k1_row = {"shape": [1, 8, t, t, 64], "design": DESIGN[torch.bfloat16],
              "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
              "bound_by": k1_bound[1],
              "library_ms": sdpa_ms}
    print("sequence parallel " + json.dumps({
        "shape": [1, 8, t, 64], "dtype": "bfloat16", "causal": True,
        "shards": n, "mesh": [str(x) for x in devices],
        "kernel1_ms": k1_ms, "kernel1_bound_ms": k1_bound[0],
        "sdpa_ms": sdpa_ms, "schemes": rows,
        "carry_launches": total}), flush=True)
    del q, k, v, ref, lim, outs

    # 9(c): gradients, f32 at T=2048, against kernels 1, 3 and 4
    t = 2048
    base = [torch.randn((1, 8, t, 64), generator=gen, device="cuda")
            for _ in range(3)]
    ref_in = [x.clone().requires_grad_() for x in base]
    (ak.flash_attention(*ref_in, True) ** 2).sum().backward()
    grads = {}
    for scheme in ("ring", "zigzag"):
        xs = [x.clone().requires_grad_() for x in base]
        (fns[scheme](*xs) ** 2).sum().backward()
        shares = {}
        for name, x, r in zip("qkv", xs, ref_in):
            shares[f"d{name}"] = float((x.grad - r.grad).abs().max()
                                       / (SP_GRAD_ATOL * r.grad.abs().max()))
        grads[scheme] = shares
        check(max(shares.values()) <= 1,
              f"{scheme} gradients differ from flash_attention's: "
              f"{shares} of the limit")
    print("sequence parallel gradients " + json.dumps({
        "shape": [1, 8, t, 64], "dtype": "float32",
        "max_share_of_limit": grads}), flush=True)
    torch.cuda.empty_cache()
    return total, k1_row


def stem_bound(b, h2, w2, k, cin, n_out, dtype, with_bias):
    """Least time (ms) of one stem call and what bounds it: x2, wk and the
    bias read once, the output written once; 2 * k*k*C_in operations an
    output element (the function's own count: the s2d GEMM's zero-padded
    kernel does kt*kt*4*C_in, 64/49 more at k = 7)."""
    kt = (k + 1) // 2
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h2 * w2 * 4 * cin + kt * kt * 4 * cin * n_out
              + b * h2 * w2 * n_out) * elem + (4 * n_out if with_bias else 0)
    return roofline(2.0 * b * h2 * w2 * k * k * cin * n_out, nbytes, dtype)


def stem_design(x_dtype, w_dtype, n_out):
    """Which design of kernel 5 runs (csrc/stem_conv.cu's entry point
    dispatches by dtype and O): bf16 x2 and wk with O % 8 == 0 on the
    tensor cores, everything else on the CUDA cores."""
    tc = x_dtype == w_dtype == torch.bfloat16 and n_out % 8 == 0
    return "tensor_cores" if tc else "cuda_cores_f32"


def stem_kernel_phase(sk):
    """10(a): kernel 5 against its plain version; times at the served and
    training shapes. Returns the row for the served shape."""
    from bigdl_tpu_torch.nn.conv import s2d_kernel, space_to_depth
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(f"ragged 113x115 k={k} C_in={cin} {str(dt)[6:]} "
              f"bias={bias}", 2, 226, 230, cin, k, 64, dt, bias)
             for k in (3, 7, 11) for cin in (1, 3)
             for dt in (torch.float32, torch.bfloat16)
             for bias in (False, True)]
    cases += [("served", SERVE_BATCH, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.float32, False),
              ("served with bias", SERVE_BATCH, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.float32, True),
              ("training", 128, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.bfloat16, False)]
    rows = {}
    for name, b, h, w, cin, k, n_out, dt, with_bias in cases:
        kt, pad = (k + 1) // 2, (k - 1) // 2
        front = (pad + 1) // 2
        x = torch.rand((b, h, w, cin), generator=gen, device="cuda").to(dt)
        w_oihw = (torch.randn((n_out, cin, k, k), generator=gen,
                              device="cuda") * 0.2).to(dt)
        bias = torch.randn((n_out,), generator=gen, device="cuda") \
            if with_bias else None
        x2, wk = space_to_depth(x), s2d_kernel(w_oihw)
        out = sk.stem_conv_forward(x2, wk, bias, front, kt - 1 - front)
        again = sk.stem_conv_forward(x2, wk, bias, front, kt - 1 - front)
        torch.cuda.synchronize()
        ref = sk.stem_conv_forward_plain(x2, wk, bias, front,
                                         kt - 1 - front).float()
        err = (out.float() - ref).abs()
        lim = (2 ** -7 if dt == torch.bfloat16 else 0) * ref.abs() \
            + STEM_ATOL * ref.abs().max()
        share = float((err / lim).max())
        bitwise = torch.equal(out, again)
        row = {"case": name, "x2": list(x2.shape), "k": k, "O": n_out,
               "dtype": str(dt)[6:], "design": stem_design(dt, dt, n_out),
               "max_abs_err": float(err.max()),
               "max_share_of_limit": share, "second_launch_equal": bitwise}
        if name in ("served", "training"):
            iters = 20
            row["ms"] = cuda_ms(lambda: sk.stem_conv_forward(
                x2, wk, bias, front, kt - 1 - front), iters)
            row["plain_ms"] = cuda_ms(lambda: sk.stem_conv_forward_plain(
                x2, wk, bias, front, kt - 1 - front), iters)
            bound = stem_bound(b, h // 2, w // 2, k, cin, n_out, dt,
                               with_bias)
            row["bound_ms"], row["bound_by"] = bound
            row["function_ops"] = 2 * b * (h // 2) * (w // 2) * k * k \
                * cin * n_out
            row["s2d_gemm_ops"] = 2 * b * (h // 2) * (w // 2) * kt * kt \
                * 4 * cin * n_out
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last, no copy
            row["library_ms"] = cuda_ms(lambda: F.conv2d(
                x_nchw, w_oihw, bias, 2, pad), iters)
            xp = F.pad(x2, (0, 0, front, kt - 1 - front, front,
                            kt - 1 - front)).permute(0, 3, 1, 2)
            wk_oihw = wk.permute(3, 2, 0, 1).contiguous()
            row["library_s2d_ms"] = cuda_ms(lambda: F.conv2d(
                xp, wk_oihw, bias), iters)
            # the cuDNN 7x7/s2 convolution computes the same function
            lib = F.conv2d(x_nchw, w_oihw, bias, 2, pad).permute(
                0, 2, 3, 1).float()
            row["max_abs_diff_cudnn"] = float((out.float() - lib).abs().max())
            rows[name] = row
        print("stem case " + json.dumps(row), flush=True)
        check(share <= 1 and bitwise,
              f"{name}: the stem kernel disagrees with its plain version "
              f"({share:.3f} of the limit) or a second launch differs "
              f"(equal: {bitwise})")
        del x, x2, out, again, ref, err, lim
    torch.cuda.empty_cache()
    served = rows["served"]
    training = rows["training"]
    keys = ("design", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_s2d_ms")
    return {**{k: served[k] for k in keys},
            "training_shape": {k: training[k] for k in keys}}


def _stem_counts(sk, bk):
    return sk.stem_conv_forward.launches, bk.bn_relu_forward.launches


def _reset_stem_counts(sk, bk):
    sk.stem_conv_forward.launches = 0
    bk.bn_relu_forward.launches = 0


def _check_rows(got, ref, label):
    """Served rows against the twin's: per element within SERVE_ATOL *
    max|twin row|, argmax equal wherever the top-2 margin is clear."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape and np.isfinite(got).all(),
          f"{label}: rows {got.shape} vs {ref.shape}, or not finite")
    lim = SERVE_ATOL * np.abs(ref).max(axis=1, keepdims=True)
    share = float((np.abs(got - ref) / lim).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN_TOL
    same = np.argmax(got, 1)[clear] == np.argmax(ref, 1)[clear]
    check(share <= 1 and bool(same.all()),
          f"{label}: rows differ from the cuDNN-stem twin ({share:.3f} of "
          f"the limit) or an argmax differs ({int((~same).sum())} rows)")
    return share, int(clear.sum())


def _serve(model, images, ref, traffic, sk, bk):
    """One traffic through a fresh engine with the stem switch set; the
    counts are read around warm-up plus traffic. Returns the launches."""
    from bigdl_tpu_torch.serving import InferenceEngine
    n = len(images)
    got = [None] * n
    with InferenceEngine(model, max_batch_size=SERVE_BATCH, max_wait_ms=2.0,
                         device="cuda") as eng:
        _reset_stem_counts(sk, bk)
        eng.warmup(images[0])
        t0 = time.perf_counter()
        if traffic == "burst":
            futs = [eng.submit(images[i]) for i in range(n)]
            for i, f in enumerate(futs):
                got[i] = f.result(300)
        else:
            def client(c):
                for j in range(SERVE_PER_CLIENT):
                    i = c * SERVE_PER_CLIENT + j
                    got[i] = eng.predict(images[i], timeout=300)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = _stem_counts(sk, bk)
        stats = eng.stats()
        buckets = len(eng.buckets)
    check(all(g is not None for g in got),
          f"{traffic}: {sum(g is None for g in got)} requests unresolved")
    share, clear = _check_rows(np.stack(got), ref[:n], traffic)
    want = stats["batches"] + buckets
    out = {"traffic": traffic, "requests": n, "wall_s": wall,
           "requests_per_sec": n / wall,
           **{k: stats.get(k) for k in (
               "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
               "queue_wait_ms_p50", "batch_size_p50", "bucket_hit_rate",
               "batches", "completed", "failed", "timed_out")},
           "warmup_buckets": buckets,
           "launches": {"stem_conv": launches[0],
                        "bn_relu_fwd": launches[1]},
           "max_share_of_limit": share, "argmax_rows_checked": clear}
    print("stem serving " + json.dumps(out), flush=True)
    check(stats["completed"] == n and stats["failed"] == 0,
          f"{traffic}: completed {stats['completed']} of {n}")
    check(launches == (want, want),
          f"{traffic}: launches (stem, BN+ReLU) {launches} != batches "
          f"{stats['batches']} + warm-up buckets {buckets} each")
    return launches[0]


def _randomize_bn_state(model, seed):
    """BN gammas U(0.5, 1.5) (U(0.05, 0.15) where zero-initialized), betas
    N(0, 0.1), running means N(0, 0.1), variances U(0.5, 1.5): the init's
    1 / 0 / 0 / 1 would make every fold the identity."""
    from bigdl_tpu_torch.nn import BatchNormalization
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization):
                n = m.n_output
                scale = 1.0 if bool(m.weight.any()) else 0.1
                m.weight.copy_((torch.rand(n, generator=gen) + 0.5) * scale)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.var.copy_(torch.rand(n, generator=gen) + 0.5)


def stem_serving_phase(sk, bk, stem_ms):
    """10(b) and 10(c). Returns kernel 5's launches on the serving path."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import BatchNormalization
    from bigdl_tpu_torch.nn import SpaceToDepthStemConvolution as S2D
    from bigdl_tpu_torch.optim import LocalPredictor

    n = max(SERVE_BURST, SERVE_CLIENTS * SERVE_PER_CLIENT)
    images = np.random.RandomState(0).rand(
        n, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    os.environ.pop(STEM_ENV, None)
    twin = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
    twin.model.get_submodule("0_conv1").pallas_stem = False
    ref = np.stack(twin.predict(images))
    bns = sum(isinstance(m, BatchNormalization) for m in twin.model.modules())
    check(bns == 1, f"the served model kept {bns} BNs, not the stem's one")

    # with the switch unset, kernel 5 never launches
    off = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
    _reset_stem_counts(sk, bk)
    off.predict(images[:SERVE_BATCH])
    check(_stem_counts(sk, bk) == (0, 1),
          f"switch unset: (stem, BN+ReLU) launches {_stem_counts(sk, bk)} "
          "!= (0, 1)")

    os.environ[STEM_ENV] = "1"
    try:
        launches = 0
        for traffic in ("burst", "closed loop"):
            m = SERVE_BURST if traffic == "burst" \
                else SERVE_CLIENTS * SERVE_PER_CLIENT
            launches += _serve(model, images[:m], ref, traffic, sk, bk)
        # device time of one b32 forward, and kernel 5's share of it
        on = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
        x = torch.from_numpy(images[:SERVE_BATCH]).cuda()
        fwd_ms = cuda_ms(lambda: on._forward(x), 10)
        twin_fwd_ms = cuda_ms(lambda: twin._forward(x), 10)
        print("stem serving forward " + json.dumps({
            "batch": SERVE_BATCH, "forward_ms": fwd_ms,
            "cudnn_stem_forward_ms": twin_fwd_ms, "stem_kernel_ms": stem_ms,
            "stem_kernel_share": stem_ms / fwd_ms}), flush=True)

        # 10(c): the plain stem, all 53 BNs folded, the s2d stem with a bias
        plain = ResNet50(class_num=1000, device="cuda",
                         generator=torch.Generator().manual_seed(1))
        _randomize_bn_state(plain, 2)
        x8 = torch.from_numpy(images[:8]).cuda()
        with torch.inference_mode():
            want = plain.eval()(x8).cpu().numpy()
        sk.stem_conv_forward.launches = 0
        pred = LocalPredictor(plain, batch_size=8, device="cuda")
        got = np.stack(pred.predict(images[:8]))
        stem = pred.model.get_submodule("0_conv1")
        left = sum(isinstance(m, BatchNormalization)
                   for m in pred.model.modules())
        err = float(np.abs(got - want).max())
        plain_out = {"batch": 8, "bns_left": left,
                     "stem": type(stem).__name__,
                     "stem_bias": stem.bias is not None,
                     "max_abs_err": err,
                     "limit": SERVE_ATOL * float(np.abs(want).max()),
                     "launches": sk.stem_conv_forward.launches}
        print("stem plain-stem branch " + json.dumps(plain_out), flush=True)
        check(left == 0 and type(stem) is S2D and stem.bias is not None,
              f"plain stem: {left} BNs left, stem {type(stem).__name__}, "
              f"bias {stem.bias is not None}")
        check(err <= plain_out["limit"] and np.isfinite(got).all(),
              f"plain stem: converted outputs off by {err:.3e}")
        check(plain_out["launches"] == 1,
              f"plain stem: kernel 5 launched {plain_out['launches']} "
              "times for one batch")
    finally:
        os.environ.pop(STEM_ENV, None)
    del model, twin, off, on, plain, pred
    torch.cuda.empty_cache()
    return launches


def stem_training_phase(sk):
    """10(d): training with the stem kernel."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools import ab_stem

    torch.backends.cudnn.deterministic = True
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy((rs.randint(0, 1000, size=8) + 1).astype(np.int32))
    batch = MiniBatch(x.cuda(), y.cuda())
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    twin = ResNet50(class_num=1000, s2d_stem=True, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]), ClassNLLCriterion(),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    try:
        os.environ[STEM_ENV] = "1"
        sk.stem_conv_forward.launches = 0
        got = train3(model)
        launches = sk.stem_conv_forward.launches
    finally:
        os.environ.pop(STEM_ENV, None)
    ref = train3(twin)
    twin_launches = sk.stem_conv_forward.launches - launches
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("stem training parity " + json.dumps({
        "batch": 8, "steps": 3, "dtype": "float32", "losses": got,
        "twin_losses": ref, "rel_diff": rel, "launches": launches,
        "twin_launches": twin_launches}), flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"stem kernel f32 losses {got} vs twin {ref}: relative "
          f"{max(rel):.2e} > {PARITY_RTOL}")
    check(launches == 3 and twin_launches == 0,
          f"stem kernel launches {launches} (3 expected) and "
          f"{twin_launches} in the twin (0 expected)")
    del model, twin, batch
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    micro = ab_stem.stem_micro(device="cuda")
    print("stem ab micro " + json.dumps(micro), flush=True)
    check(micro["kernel_launches"] > 0, "the micro-benchmark launched no "
                                        "stem kernel")
    loop = ab_stem.full_loop(warmup=8, iters=24, device="cuda")
    print("stem ab loop " + json.dumps(loop), flush=True)
    for label, want in (("cudnn", 0), ("kernel", 32)):
        res = loop[label]
        check(res["stem_kernel_launches"] == want
              and np.isfinite(res["loss_last"]),
              f"ab loop {label}: {res['stem_kernel_launches']} stem kernel "
              f"launches (want {want}), last loss {res['loss_last']}")
    # the same weights and batch: the first bf16 losses differ only by the
    # stem's roundings
    first = (loop["cudnn"]["loss_first"], loop["kernel"]["loss_first"])
    check(abs(first[0] - first[1]) <= 1e-2 * abs(first[0]),
          f"ab loop first losses {first} differ by more than 1%")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 11. the training loop's accounting and safety net
# --------------------------------------------------------------------------

P11_STEPS, P11_EVERY = 12, 4
# (c): the loss on the card against the CPU, relative; rows whose deciding
# margin (top-1 over top-2, top-5 over top-6) is under MARGIN_TOL may flip
EVAL_RTOL = 1e-4
# (d): each updated parameter with accumulation against without, per
# element, relative to the tensor's largest element (f32, TF32 off: the
# same sums in another order); the updates' own difference is reported
ACCUM_RTOL = 1e-4
# (a), (b): the relative limit on losses when an op of the path warned that
# it is not deterministic (bit for bit otherwise)
NONDET_RTOL = 1e-3


def p11_data(device):
    """The training set: three seeded batches of 128 images (RandomState(0))
    on `device`; the held-out set: eight seeded batches of 32
    (RandomState(1))."""
    from bigdl_tpu_torch.dataset import MiniBatch

    def batches(seed, n, size):
        rs = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            x = rs.rand(size, 224, 224, 3).astype(np.float32)
            y = (rs.randint(0, 1000, size) + 1).astype(np.int32)
            out.append(MiniBatch(torch.from_numpy(x).to(device),
                                 torch.from_numpy(y).to(device)))
        return out

    return batches(0, 3, 128), batches(1, 8, 32)


def p11_configure(opt, held, ckpt_dir):
    """Phase 11's settings on an optimizer; returns the list its hook fills
    with (step, loss, score)."""
    from bigdl_tpu_torch.optim import (SGD, Loss, Top1Accuracy,
                                       Top5Accuracy, max_iteration,
                                       several_iteration)
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_validation(several_iteration(P11_EVERY), held,
                       [Top1Accuracy(), Top5Accuracy(), Loss()])
    opt.set_checkpoint(ckpt_dir, several_iteration(P11_EVERY),
                       keep_last_n=2)
    opt.set_end_when(max_iteration(P11_STEPS))
    record = []
    opt.set_iteration_hook(lambda s: record.append(
        (s["neval"], s["loss"], s.get("score"), time.perf_counter())))
    return record


def p11_model(device):
    from bigdl_tpu_torch.models import ResNet50
    return ResNet50(class_num=1000, s2d_stem=True, device=device,
                    generator=torch.Generator().manual_seed(0))


def p11_resnet_run(ckpt_dir, resume=False):
    """(a)'s run: the model, the optimizer over three b128 batches, its
    record; resumed from the newest checkpoint under `ckpt_dir` first when
    `resume`."""
    from bigdl_tpu_torch.dataset import LocalDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer
    train, held = p11_data("cuda")
    model = p11_model("cuda")
    opt = DistriOptimizer(model, LocalDataSet(train, seed=0),
                          ClassNLLCriterion(), devices=["cuda"])
    record = p11_configure(opt, held, ckpt_dir)
    if resume:
        check(opt.resume_from_latest_checkpoint(),
              f"nothing to resume from under {ckpt_dir}")
    return model, opt, record, held


class Deterministic:
    """`torch.use_deterministic_algorithms(True, warn_only=True)` with cuDNN
    deterministic for the block; `ops` names every op that warned that it
    has no deterministic implementation."""

    def __enter__(self):
        self._warn = warnings.catch_warnings(record=True)
        self.caught = self._warn.__enter__()
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        self._warn.__exit__(*exc)
        return False

    @property
    def ops(self):
        return sorted({str(w.message).split(" does not have")[0]
                       for w in self.caught
                       if "does not have a deterministic" in str(w.message)})


def resume_child(ckpt_dir, out_path):
    """Phase 11(a)'s fresh process: resume from the newest checkpoint under
    `ckpt_dir`, train to step 12, and write the record and the parameters
    to `out_path` (+ ".json")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bigdl_tpu_torch.ops import _build
    _build.build_kernels()
    with Deterministic() as det:
        model, opt, record, _ = p11_resnet_run(ckpt_dir, resume=True)
        start = opt.optim_method.state["neval"]
        opt.optimize()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               out_path)
    with open(out_path + ".json", "w") as f:
        json.dump({"start": start, "record": record,
                   "nondeterministic_ops": det.ops}, f)
    return 0


def _same(a, b, rtol):
    """Bitwise when `rtol` is 0, else within `rtol` relative."""
    if rtol == 0:
        return a == b
    return all(abs(x - y) <= rtol * abs(y) for x, y in zip(a, b))


def resume_phase(bk, tmp):
    """(a): the uninterrupted run here, the resumed one in a fresh
    process. Returns the trained model's parameters (on the CPU), the
    held-out batches, and the limit (b) holds its losses to."""
    from bigdl_tpu_torch.serialization import valid_checkpoints
    ckpt = os.path.join(tmp, "a")
    _reset_bn_counts(bk)
    t0 = time.perf_counter()
    with Deterministic() as det:
        model, opt, record, held = p11_resnet_run(ckpt)
        opt.optimize()
    run_s = time.perf_counter() - t0
    launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    kept = [os.path.basename(p) for p in valid_checkpoints(ckpt)]
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rtol = NONDET_RTOL if det.ops else 0.0
    resume_dir = os.path.join(tmp, "resume")
    shutil.copytree(os.path.join(ckpt, "iter8"),
                    os.path.join(resume_dir, "iter8"))
    out_path = os.path.join(tmp, "resumed.pt")
    del opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-child",
         resume_dir, out_path], capture_output=True, text=True,
        timeout=600)
    child_s = time.perf_counter() - t0
    check(child.returncode == 0, f"the resumed process failed "
          f"(exit {child.returncode}): {child.stderr[-2000:]}")
    with open(out_path + ".json") as f:
        resumed = json.load(f)
    theirs = torch.load(out_path)
    diff = [k for k in state if not torch.equal(state[k], theirs[k])]
    rel = max((float((state[k].float() - theirs[k].float()).abs().max())
               / max(float(state[k].float().abs().max()), 1e-30))
              for k in state)
    full = [r[1] for r in record]
    rest = [r[1] for r in resumed["record"]]
    scores = [r[2] for r in record if r[0] % P11_EVERY == 0]
    print("training loop resume " + json.dumps({
        "model": "ResNet50 s2d", "batch": 128, "steps": P11_STEPS,
        "precision": "bfloat16 compute, f32 masters",
        "losses": full, "resumed_from": resumed["start"],
        "resumed_losses": rest, "scores": scores,
        "checkpoints_left": kept, "params_differing": len(diff),
        "params_max_rel_diff": rel,
        "nondeterministic_ops": det.ops,
        "child_nondeterministic_ops": resumed["nondeterministic_ops"],
        "launches": launches, "run_s": run_s, "fresh_process_s": child_s}),
        flush=True)
    check(kept == ["iter12", "iter8"], f"checkpoints left: {kept}")
    check(resumed["start"] == 8, f"resumed at {resumed['start']}, not 8")
    check(len(full) == P11_STEPS and all(np.isfinite(full)),
          f"losses {full}")
    check(all(s is not None for s in scores), f"validation scores {scores}")
    if rtol == 0:
        check(rest == full[8:] and not diff,
              f"resumed losses {rest} vs {full[8:]}, {len(diff)} tensors "
              "differ: not bit for bit")
    else:
        check(_same(rest, full[8:], rtol) and rel <= rtol,
              f"resumed losses {rest} vs {full[8:]} (ops not "
              f"deterministic: {det.ops}), params {rel:.2e} > {rtol}")
    check(launches[1] == BN_SITES * P11_STEPS
          and launches[0] > BN_SITES * P11_STEPS,
          f"BN+ReLU launches {launches}: want {BN_SITES} backward a step, "
          "and forwards in training and validation")
    return model, held, rtol


def retry_phase(tmp, rtol):
    """(b): the same configuration at b32 through the `Optimizer` factory,
    unfaulted, then with a `train.step` fault at the 6th step."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                            RetryPolicy,
                                            TransientInjectedFault)
    train, held = p11_data("cuda")
    small = [MiniBatch(b.inputs[0][i:i + 32], b.targets[0][i:i + 32])
             for b in train for i in range(0, 128, 32)]

    def run(name, fault=None):
        model = p11_model("cuda")
        opt = Optimizer(model, LocalDataSet(small, seed=0),
                        ClassNLLCriterion(), 32, local=False, device="cuda",
                        retry_policy=RetryPolicy(max_retries=3,
                                                 base_delay_s=0.05, seed=0))
        record = p11_configure(opt, held, os.path.join(tmp, name))
        if fault is None:
            opt.optimize()
        else:
            with fault:
                opt.optimize()
        del model, opt
        torch.cuda.empty_cache()
        return record

    faulted_at = []

    def injected(ctx):
        faulted_at.append(time.perf_counter())
        return TransientInjectedFault(f"injected at step {ctx['step']}")

    with Deterministic() as det:
        clean = run("clean")
        plan = FaultInjector(FaultSpec("train.step", at_hit=6,
                                       exc=injected))
        faulted = run("faulted", plan)
    after = faulted[5:]
    steps = [r[0] for r in faulted]
    recover_s = after[0][3] - faulted_at[0] if faulted_at and after \
        else float("nan")
    got, want = [r[1] for r in after], [r[1] for r in clean[4:]]
    rtol = max(rtol, NONDET_RTOL if det.ops else 0.0)
    print("training loop retry " + json.dumps({
        "batch": 32, "fault": "train.step at hit 6", "fired": plan.fired,
        "steps": steps, "losses_unfaulted": [r[1] for r in clean],
        "losses_faulted": [r[1] for r in faulted],
        "time_to_recover_s": recover_s,
        "time_to_recover": "from the fault to the end of the first step "
                           "after the reload of the step-4 checkpoint",
        "nondeterministic_ops": det.ops}), flush=True)
    check(plan.fired == [("train.step", 6)], f"fired {plan.fired}")
    check(steps == [1, 2, 3, 4, 5] + list(range(5, P11_STEPS + 1)),
          f"the faulted run's steps {steps}: no recovery from step 4")
    check(_same(got, want, rtol), f"losses after the recovery {got} vs "
          f"the unfaulted run's {want} (limit {rtol})")
    return recover_s


def _deciding_margins(out):
    """Per row: top-1 over top-2 and top-5 over top-6, the margins that
    decide Top1 and Top5."""
    top = torch.topk(out.float(), 6, dim=-1).values
    return top[:, 0] - top[:, 1], top[:, 4] - top[:, 5]


def evaluator_phase(model, held):
    """(c): Evaluator on the card against the CPU (plain kernels)."""
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.optim import (Evaluator, Loss, Top1Accuracy,
                                       Top5Accuracy)

    def methods():
        return [Top1Accuracy(), Top5Accuracy(), Loss()]

    card = Evaluator(model, 32)
    t0 = time.perf_counter()
    full = card.test(held, methods())
    full_s = time.perf_counter() - t0
    part = held[:2]
    on_card = card.test(part, methods())
    cpu = Evaluator(copy.deepcopy(model).cpu(), 32, device="cpu")
    cpu_part = [MiniBatch(b.inputs[0].cpu(), b.targets[0].cpu())
                for b in part]
    t0 = time.perf_counter()
    on_cpu = cpu.test(cpu_part, methods())
    cpu_s = time.perf_counter() - t0
    near = [0, 0]
    for b in cpu_part:
        m1, m5 = _deciding_margins(cpu._pred._forward(b.inputs[0]))
        near[0] += int((m1 < MARGIN_TOL).sum())
        near[1] += int((m5 < MARGIN_TOL).sum())
    loss_rel = abs(on_card[2].result()[0] - on_cpu[2].result()[0]) / abs(
        on_cpu[2].result()[0])
    print("training loop evaluator " + json.dumps({
        "held_out": [repr(r) for r in full], "held_out_s": full_s,
        "images_compared": 64, "card": [repr(r) for r in on_card],
        "cpu": [repr(r) for r in on_cpu], "cpu_s": cpu_s,
        "loss_rel_diff": loss_rel, "rows_under_margin_top1_top5": near}),
        flush=True)
    check(full[0].result()[1] == 256, f"held-out count {full[0]}")
    check(loss_rel <= EVAL_RTOL, f"Evaluator loss card vs CPU: relative "
          f"{loss_rel:.2e} > {EVAL_RTOL}")
    for i, label in enumerate(("Top1", "Top5")):
        d = abs(on_card[i].correct - on_cpu[i].correct)
        check(d <= near[i], f"{label} counts card {on_card[i]} vs CPU "
              f"{on_cpu[i]}: {d} apart, {near[i]} rows near a tie")


def lm_loop_phase(ak, lm_unclipped):
    """(d): gradient accumulation on the LM (f32) and the benchmark recipe
    with clipping (bf16)."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools.bench import _resident_optimizer, _token_batch

    x, y = _token_batch(LM_CFG["vocab_size"], 2048, 8)
    batch = MiniBatch(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    base = TransformerLM(**LM_CFG, device="cuda",
                         generator=torch.Generator().manual_seed(0))

    def one_step(accum):
        """The parameters after one step, their updates, the flash
        launches and the loss."""
        model = copy.deepcopy(base)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = DistriOptimizer(model, LocalDataSet([batch]),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(1))
        if accum > 1:
            opt.set_gradient_accumulation(accum)
        _reset_flash_counts(ak)
        opt.optimize()
        counts = _flash_counts(ak)
        after = {k: p.detach() for k, p in model.named_parameters()}
        return after, {k: after[k] - before[k] for k in after}, counts, \
            opt.optim_method.state["loss"]

    def worst(a, b):
        """The largest per-tensor max|a - b| / max|b|."""
        return max(float((a[k] - b[k]).abs().max())
                   / max(float(b[k].abs().max()), 1e-30) for k in b)

    full, d_full, full_counts, full_loss = one_step(1)
    acc, d_acc, acc_counts, acc_loss = one_step(2)
    rel, share = worst(acc, full), worst(d_acc, d_full)
    del base
    torch.cuda.empty_cache()

    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    opt = _resident_optimizer(model, x, y,
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              torch.device("cuda"))
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(max_iteration(P11_STEPS))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    _reset_flash_counts(ak)
    opt.optimize()
    clipped_counts = _flash_counts(ak)
    print("training loop lm " + json.dumps({
        "batch": 8, "seq": 2048, "accumulation": {
            "dtype": "float32", "tf32": False, "steps": 2,
            "loss": acc_loss, "loss_without": full_loss,
            "params_max_rel_diff": rel, "update_max_diff_share": share,
            "launches_fwd_dq_dkv": acc_counts,
            "launches_without": full_counts},
        "clipped_recipe": {
            "precision": "bfloat16 compute, f32 masters", "clip_norm": 1.0,
            "losses": losses, "finite": int(np.isfinite(losses).sum()),
            "unclipped_losses_first_12": lm_unclipped[:P11_STEPS],
            "launches_fwd_dq_dkv": clipped_counts}}), flush=True)
    check(rel <= ACCUM_RTOL, f"parameters after a step with accumulation "
          f"2 differ by {rel:.2e} of their largest element (limit "
          f"{ACCUM_RTOL})")
    check(full_counts == (LM_LAYERS,) * 3 and acc_counts == (2 * LM_LAYERS,)
          * 3, f"flash launches {full_counts} without accumulation, "
          f"{acc_counts} with 2")
    check(clipped_counts == (LM_LAYERS * P11_STEPS,) * 3,
          f"flash launches {clipped_counts} in {P11_STEPS} steps")
    check(len(losses) == P11_STEPS and math.isfinite(losses[0]),
          f"clipped recipe losses {losses}")
    return losses


def _mfu_ok(v):
    return v is not None and 0 < v < 1


def mfu_phase(resnet, lm):
    """(e): the FLOP count and mfu of each tools/bench.py path, and one
    count whatever runs the kernels."""
    from bigdl_tpu_torch.observability import costs
    from bigdl_tpu_torch.tools.bench import (bench_attention,
                                             bench_resnet50_serving)
    name = torch.cuda.get_device_name(0)
    serve = bench_resnet50_serving(device="cuda",
                                   generator=torch.Generator().manual_seed(0))
    attention = bench_attention(device="cuda")
    calls = [(f"{kind} T={e['seq']}", e) for kind in ("flash",
             "flash_fwd_bwd", "naive") for e in attention[kind]] + [
        (scheme, attention["sequence_parallel"][scheme])
        for scheme in ("ring", "zigzag")]
    paths = {
        "resnet50": {"flops_per_step": resnet["flops_per_step"],
                     "ms_per_step": resnet["ms_per_step"],
                     "mfu": resnet["mfu"]},
        "lm": {"flops_per_step": lm["flops_per_step"],
               "ms_per_step": lm["ms_per_step"], "mfu": lm["mfu"]},
        "serve": {"flops_per_forward": serve["flops_per_forward"],
                  "cudnn_stem_ms": serve["cudnn_stem_ms"],
                  "cudnn_stem_mfu": serve["cudnn_stem_mfu"],
                  "stem_kernel_ms": serve["stem_kernel_ms"],
                  "stem_kernel_mfu": serve["stem_kernel_mfu"]},
        "attention": {label: {k: e[k] for k in ("flops", "ms", "tflops",
                                                "mfu")}
                      for label, e in calls}}
    routes = route_counts()
    print("training loop mfu " + json.dumps({
        "device": name, "peak_bf16_flops": costs.peak_flops(name),
        "paths": paths, "one_count_per_step": routes}), flush=True)
    check(costs.peak_flops(name) is not None,
          f"{name!r} is not in costs.PEAK_BF16_FLOPS")
    mfus = [("resnet50", resnet["mfu"]), ("lm", lm["mfu"]),
            ("serve cudnn stem", serve["cudnn_stem_mfu"]),
            ("serve stem kernel", serve["stem_kernel_mfu"])] + [
        (f"attention {label}", e["mfu"]) for label, e in calls]
    bad = [(k, v) for k, v in mfus if not _mfu_ok(v)]
    check(not bad, f"mfu outside (0, 1): {bad}")
    for model, counts in routes.items():
        check(len(set(counts.values())) == 1,
              f"{model} step counted {counts} on the card, CPU and meta")


def route_counts():
    """A small ResNet and a small LM step counted by `costs.count_flops` on
    the card (the kernels), on the CPU (their plain versions) and on the
    meta device (shapes only)."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import ResNet, TransformerLM
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.observability import costs
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer
    from bigdl_tpu_torch.tools.bench import step_flops

    rs = np.random.RandomState(5)
    cases = {
        "resnet8 b4 16x16": (
            lambda dev: ResNet(10, depth=8, data_set="cifar10", device=dev,
                               generator=torch.Generator().manual_seed(0)),
            rs.rand(4, 16, 16, 3).astype(np.float32),
            (rs.randint(0, 10, 4) + 1).astype(np.int32),
            ClassNLLCriterion()),
        "lm 2 layers b2 T=64": (
            lambda dev: TransformerLM(64, embed_dim=64, n_layer=2, n_head=2,
                                      device=dev,
                                      generator=torch.Generator()
                                      .manual_seed(0)),
            rs.randint(1, 65, (2, 64)).astype(np.int32),
            rs.randint(1, 65, (2, 64)).astype(np.int32),
            TimeDistributedCriterion(ClassNLLCriterion()))}
    out = {}
    for label, (make, x, y, crit) in cases.items():
        counts = {}
        for dev in ("cuda", "cpu"):
            model = make(dev)
            opt = DistriOptimizer(model, LocalDataSet([MiniBatch(x, y)]),
                                  crit, devices=[dev])
            opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
            state = opt.optim_method.init_state_with_masters(
                dict(model.named_parameters()))
            counts[dev] = costs.count_flops(
                opt._build_step(), state, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev), 0.01)
            if dev == "cpu":
                counts["meta"] = step_flops(opt)
        out[label] = counts
    return out


# --------------------------------------------------------------------------
# 12. the feed-forward zoo
# --------------------------------------------------------------------------

# fused BN+ReLU sites a training step: Inception-v2 (after every one of its
# 69 convolutions) and VggForCifar10 (13 convolution blocks and the 1-D BN)
V2_SITES = 69
CIFAR_VGG_SITES = 14
# Inception-v2's Concat gradient slices a step (the last BN+ReLU of each
# branch that has one: 4 in each of 8 blocks, 2 in the 2 reduction blocks)
# are read in place by kernel 7; the gradient copies a step that remain
V2_G_COPIES = 0
# kernels 6-7 at the zoo's new sites, (label, N, C) of the [N, C] view
ZOO_BN_SHAPES = [("v2 7x7 C=352", 32 * 7 * 7, 352),
                 ("v2 28x28 C=96", 32 * 28 * 28, 96),
                 ("cifar vgg 2-D [32, 512]", 32, 512)]
# the width of the joined Concat gradient each of those sites is a slice
# of, and the slice's offset (the 2-D site gets a slice of the same form)
ZOO_G_SLICES = {"v2 7x7 C=352": (1024, 0), "v2 28x28 C=96": (256, 64),
                "cifar vgg 2-D [32, 512]": (1024, 256)}
# the zoo's benchmark configurations, `tools/bench.py --model <name>`
ZOO_BENCH = ("lenet", "inception_v1", "inception_v2", "vgg16")


# (lead_us, tail_us, events seen, calls) of each profile window taken
# since the last `profile_window_summary`: lead is how long after the
# first measured call's host time its first device event starts
# (negative where a device timestamp reads earlier than the host's
# clock), tail how long before the host saw the device drained the last
# event ends
PROFILE_WINDOWS = []


def device_profile(fn, reps=20):
    """(device ms, device kernels) of one call of `fn`: every kernel it
    launches, summed over `reps` calls under `torch.profiler` and divided
    by `reps`. Back-to-back CUDA events time the host's issue rate instead
    when a call's kernels take less time than its launches. Each window
    opens with `tools.bench.open_profile_window`'s spin kernels, left out
    of the count: some minutes into the run, every other window on the
    card loses its first 9-12 device records. A profile that still lost
    a device event is taken again, up to 3 times in all; one that never
    sees every call fails."""
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.tools.bench import (close_profile_window,
                                             is_profile_marker,
                                             open_profile_window)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_in = time.perf_counter()
            open_profile_window()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            close_profile_window()
        ev = [e.time_range for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not is_profile_marker(e.name)]
        us = [r.elapsed_us() for r in ev]
        if ev:
            PROFILE_WINDOWS.append(
                (min(r.start for r in ev) - 1e6 * (t0 - t_in),
                 1e6 * (t1 - t_in) - max(r.end for r in ev), len(ev), reps))
        if len(us) >= reps and len(us) % reps == 0:
            break
    check(len(us) >= reps, f"the profiler saw {len(us)} device events in "
                           f"{reps} calls, three times")
    return sum(us) / reps / 1e3, len(us) / reps


def profile_window_summary():
    """The profile windows taken since the last call, as one JSON-able
    dict; empties PROFILE_WINDOWS."""
    w = PROFILE_WINDOWS[:]
    PROFILE_WINDOWS.clear()
    return {"windows": len(w),
            "min_lead_us": min((x[0] for x in w), default=None),
            "min_tail_us": min((x[1] for x in w), default=None),
            "short": sum(1 for x in w if x[2] < x[3] or x[2] % x[3])}


def device_ms(fn, reps=20):
    """Device time (ms) of one call of `fn` (`device_profile`)."""
    return device_profile(fn, reps)[0]


def zoo_kernel_phase(sk, bk):
    """12(a): kernel 5 with its bias at Inception-v1's b64 shape, kernels
    6-7 at Inception-v2's and VggForCifar10's sites (x bf16 and f32; the
    backward given a channel slice of a Concat gradient, read in place,
    with the same dscale/dshift bits as on the contiguous copy), each
    against its plain version
    with phases 5's and 10's limits, timed beside its bound. Kernels 6-7
    at these sites take less device time than a launch: `ms` (CUDA
    events over back-to-back calls) is then the host's issue rate, and
    `device_ms` (the profiler) the kernels' own time."""
    from bigdl_tpu_torch.nn.conv import s2d_kernel, space_to_depth
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {"stem": [], "fwd": [], "bwd": []}
    x = torch.rand((64, 224, 224, 3), generator=gen, device="cuda")
    w_oihw = torch.randn((64, 3, 7, 7), generator=gen, device="cuda") * 0.2
    bias32 = torch.randn((64,), generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        # in bf16 training the bias arrives as the bf16 copy of its master
        xd, wd, bias = x.to(dt), w_oihw.to(dt), bias32.to(dt)
        x2, wk = space_to_depth(xd), s2d_kernel(wd)
        out = sk.stem_conv_forward(x2, wk, bias, 2, 1)
        again = sk.stem_conv_forward(x2, wk, bias, 2, 1)
        torch.cuda.synchronize()
        ref = sk.stem_conv_forward_plain(x2, wk, bias, 2, 1).float()
        err = (out.float() - ref).abs()
        lim = (2 ** -7 if dt == torch.bfloat16 else 0) * ref.abs() \
            + STEM_ATOL * ref.abs().max()
        share = float((err / lim).max())
        bitwise = torch.equal(out, again)
        x_nchw = xd.permute(0, 3, 1, 2)
        bound = stem_bound(64, 112, 112, 7, 3, 64, dt, True)
        row = {"case": f"inception_v1 b64 bias {str(dt)[6:]}",
               "x2": list(x2.shape), "O": 64,
               "design": stem_design(dt, dt, 64),
               "max_abs_err": float(err.max()), "max_share_of_limit": share,
               "second_launch_equal": bitwise,
               "ms": cuda_ms(lambda: sk.stem_conv_forward(
                   x2, wk, bias, 2, 1), 20),
               "plain_ms": cuda_ms(lambda: sk.stem_conv_forward_plain(
                   x2, wk, bias, 2, 1), 10),
               "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": cuda_ms(lambda: F.conv2d(
                   x_nchw, wd, bias, 2, 3), 20)}
        print("zoo stem case " + json.dumps(row), flush=True)
        check(share <= 1 and bitwise,
              f"{row['case']}: the stem kernel disagrees with its plain "
              f"version ({share:.3f} of the limit) or a second launch "
              f"differs (equal: {bitwise})")
        rows["stem"].append(row)
        del xd, wd, x2, wk, out, again, ref, err, lim, x_nchw
    del x
    torch.cuda.empty_cache()

    for label, n, c in ZOO_BN_SHAPES:
        width, offset = ZOO_G_SLICES[label]
        x32 = torch.randn((n, c), generator=gen, device="cuda")
        scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((c,), generator=gen, device="cuda") * 0.5
        g = torch.randn((n, width), generator=gen, device="cuda").to(
            torch.bfloat16)[:, offset:offset + c]
        gc = g.contiguous()
        # x bf16 as the main path hands it, then f32 as earlier slices did
        for x_dt in (torch.bfloat16, torch.float32):
            x2 = x32.to(x_dt)
            xf = x2.float()
            # the fused tail as a BN layer calls it: the f32 copy is the
            # differentiable input, the kernels read x2 (`source`), and
            # the Function hands kernel 7 the strided slice in place
            xr = xf.clone().requires_grad_()
            copies = bk.BnReluFunction.g_copies
            y = bk.bn_relu(xr, scale, shift, True, torch.bfloat16,
                           source=None if x_dt == torch.float32 else x2)
            dx = torch.autograd.grad(y, xr, g)[0]
            y = y.detach()
            torch.cuda.synchronize()
            check(bk.BnReluFunction.g_copies == copies,
                  f"{label}: the Concat gradient slice was copied")
            y_ref = bk.bn_relu_forward_plain(x2, scale, shift, True,
                                             torch.bfloat16)
            dx_k, ds, db = bk.bn_relu_backward(x2, scale, shift, g, True)
            _, ds_c, db_c = bk.bn_relu_backward(x2, scale, shift, gc, True)
            dx_ref, ds_ref, db_ref = bk.bn_relu_backward_plain(
                x2, scale, shift, gc, True)
            gm = torch.where((x2 * scale + shift).to(torch.bfloat16) > 0,
                             gc.float(), 0.0)
            ok = (torch.equal(y, y_ref) and torch.equal(dx, dx_ref)
                  and torch.equal(dx_k, dx_ref)
                  and torch.equal(ds, ds_c) and torch.equal(db, db_c)
                  and bool(((ds - ds_ref).abs()
                            <= BN_SUM_RTOL * (gm * xf).abs().sum(0)).all())
                  and bool(((db - db_ref).abs()
                            <= BN_SUM_RTOL * gm.abs().sum(0)).all()))
            fwd_bound = bn_relu_bound(n, c, x_dt, torch.bfloat16, False)
            bwd_bound = bn_relu_bound(n, c, x_dt, torch.bfloat16, True)
            iters = 50
            fwd = {"case": f"{label} x {str(x_dt)[6:]} y bfloat16",
                   "max_abs_err": float(
                       (y.float() - y_ref.float()).abs().max()),
                   "ms": cuda_ms(lambda: bk.bn_relu_forward(
                       x2, scale, shift, True, torch.bfloat16), iters),
                   "plain_ms": cuda_ms(lambda: bk.bn_relu_forward_plain(
                       x2, scale, shift, True, torch.bfloat16), iters),
                   "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                   "library_ms": None}
            bwd = {"case": f"{label} x {str(x_dt)[6:]} g bfloat16 (a slice "
                           f"of [{n}, {width}], read in place)",
                   "max_abs_err": float((dx - dx_ref).abs().max()),
                   "max_abs_err_dscale": float((ds - ds_ref).abs().max()),
                   "max_abs_err_dshift": float((db - db_ref).abs().max()),
                   "ms": cuda_ms(lambda: bk.bn_relu_backward(
                       x2, scale, shift, g, True), iters),
                   "plain_ms": cuda_ms(lambda: bk.bn_relu_backward_plain(
                       x2, scale, shift, gc, True), iters),
                   "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                   "library_ms": None}
            fwd["device_ms"], fwd["kernels_per_call"] = device_profile(
                lambda: bk.bn_relu_forward(x2, scale, shift, True,
                                           torch.bfloat16))
            bwd["device_ms"], bwd["kernels_per_call"] = device_profile(
                lambda: bk.bn_relu_backward(x2, scale, shift, g, True))
            for row in (fwd, bwd):
                row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            print("zoo bn_relu case " + json.dumps({"ok": ok, "fwd": fwd,
                                                    "bwd": bwd}), flush=True)
            check(ok, f"{label} x {x_dt}: a BN+ReLU kernel disagrees with "
                      "its plain version (y or dx not bitwise, dscale/"
                      f"dshift beyond {BN_SUM_RTOL} * sum|terms|, or the "
                      "slice's sums not the contiguous copy's bits)")
            check(fwd["kernels_per_call"] == bwd["kernels_per_call"] == 1,
                  f"{label}: {fwd['kernels_per_call']} forward and "
                  f"{bwd['kernels_per_call']} backward device kernels a "
                  "call, not one each")
            rows["fwd"].append(fwd)
            rows["bwd"].append(bwd)
    return rows


def _zoo_data(batch, shape, n_class, seed):
    from bigdl_tpu_torch.dataset import MiniBatch
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.rand(batch, *shape).astype(np.float32))
    y = torch.from_numpy((rs.randint(0, n_class, batch) + 1).astype(
        np.int32))
    return MiniBatch(x.cuda(), y.cuda())


def _zoo_counts(sk, bk):
    return {"stem_conv": sk.stem_conv_forward.launches,
            "bn_relu_fwd": bk.bn_relu_forward.launches,
            "bn_relu_bwd": bk.bn_relu_backward.launches}


def _reset_zoo_counts(sk, bk):
    sk.stem_conv_forward.launches = 0
    _reset_bn_counts(bk)


def zoo_parity_phase(sk, bk):
    """12(b): f32 parity pairs through DistriOptimizer, 3 SGD steps each:
    the model through the kernels against a twin with the same weights
    and the same step-generator seed (so the same dropout masks) that
    launches none. Returns the launches of each pair's model."""
    from bigdl_tpu_torch.dataset import LocalDataSet
    from bigdl_tpu_torch.models import (Inception_v1_NoAuxClassifier,
                                        Inception_v2_NoAuxClassifier,
                                        VggForCifar10)
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    SpaceToDepthStemConvolution,
                                    fusion_scope)
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration

    def stem_route(on):
        def set_route(m):
            for mod in m.modules():
                if isinstance(mod, SpaceToDepthStemConvolution):
                    mod.pallas_stem = on
        return set_route

    cases = [
        ("inception_v1", lambda: Inception_v1_NoAuxClassifier(
            1000, s2d_stem=True, device="cuda",
            generator=torch.Generator().manual_seed(0)),
         (224, 224, 3), 1000, 8, stem_route(True), stem_route(False), None,
         {"stem_conv": 1, "bn_relu_fwd": 0, "bn_relu_bwd": 0}),
        ("inception_v2", lambda: Inception_v2_NoAuxClassifier(
            1000, device="cuda", generator=torch.Generator().manual_seed(0)),
         (224, 224, 3), 1000, 8, None, None, False,
         {"stem_conv": 0, "bn_relu_fwd": V2_SITES,
          "bn_relu_bwd": V2_SITES}),
        ("vgg_cifar", lambda: VggForCifar10(
            10, device="cuda", generator=torch.Generator().manual_seed(0)),
         (32, 32, 3), 10, 16, None, None, False,
         {"stem_conv": 0, "bn_relu_fwd": CIFAR_VGG_SITES,
          "bn_relu_bwd": CIFAR_VGG_SITES}),
    ]
    torch.backends.cudnn.deterministic = True
    out = {}
    for name, make, shape, n_class, batch, on, off, fuse, per_step in cases:
        data = _zoo_data(batch, shape, n_class, 12)
        model = make()
        twin = make()
        twin.load_state_dict(model.state_dict())
        if on is not None:
            on(model)
            off(twin)

        def train3(m):
            losses = []
            opt = DistriOptimizer(m, LocalDataSet([data]),
                                  ClassNLLCriterion(), devices=["cuda"])
            opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
            opt.set_end_when(max_iteration(3))
            opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
            opt.optimize()
            return losses

        _reset_zoo_counts(sk, bk)
        got = train3(model)
        launches = _zoo_counts(sk, bk)
        _reset_zoo_counts(sk, bk)
        if fuse is None:
            ref = train3(twin)
        else:
            with fusion_scope(fuse):
                ref = train3(twin)
        twin_launches = _zoo_counts(sk, bk)
        rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
        print("zoo parity " + json.dumps({
            "model": name, "batch": batch, "steps": 3, "dtype": "float32",
            "losses": got, "twin_losses": ref, "rel_diff": rel,
            "launches": launches, "twin_launches": twin_launches}),
            flush=True)
        check(len(got) == 3 and all(np.isfinite(got))
              and max(rel) <= PARITY_RTOL,
              f"{name}: f32 losses {got} vs twin {ref}: relative "
              f"{max(rel):.2e} > {PARITY_RTOL}")
        want = {k: 3 * v for k, v in per_step.items()}
        check(launches == want, f"{name}: launches {launches} in 3 steps, "
                                f"want {want}")
        check(not any(twin_launches.values()),
              f"{name}: the twin launched {twin_launches}")
        out[name] = launches
        del model, twin, data
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def zoo_bench_phase(sk, bk):
    """12(c): each `tools/bench.py --model <zoo model>` configuration for 8
    warm-up and 24 timed steps (the stem kernel on for Inception-v1): the
    main path's runs, counts set to 0 before each and read after."""
    from bigdl_tpu_torch.tools.bench import ZOO, bench_zoo
    warmup, iters, sync = 8, 24, 8
    steps = warmup + iters
    per_step = {"lenet": {},
                "inception_v1": {"stem_conv": 1},
                "inception_v2": {"bn_relu_fwd": V2_SITES,
                                 "bn_relu_bwd": V2_SITES},
                "vgg16": {}}
    out = {}
    for name in ZOO_BENCH:
        if name == "inception_v1":
            os.environ[STEM_ENV] = "1"
        try:
            torch.cuda.reset_peak_memory_stats()
            _reset_zoo_counts(sk, bk)
            res = bench_zoo(name, warmup=warmup, iters=iters, sync=sync,
                            device="cuda",
                            generator=torch.Generator().manual_seed(0))
            launches = _zoo_counts(sk, bk)
            g_copies = bk.BnReluFunction.g_copies
        finally:
            os.environ.pop(STEM_ENV, None)
        losses = res["losses"]
        row = {k: res[k] for k in ("model", "imgs_per_sec", "ms_per_step",
                                   "flops_per_step", "mfu", "batch_size",
                                   "steps", "warmup", "sync", "device")}
        row.update({"precision": "bfloat16 compute, f32 masters",
                    "input": list(ZOO[name][1]), "classes": ZOO[name][2],
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "launches": launches,
                    "g_copies_per_step": g_copies / steps,
                    "peak_mem_gib": torch.cuda.max_memory_allocated()
                    / 2 ** 30})
        print("zoo bench " + json.dumps(row), flush=True)
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"{name}: non-finite or missing losses {losses}")
        check(losses[-1] < losses[0],
              f"{name}: the loss did not fall: first {losses[0]}, last "
              f"{losses[-1]}")
        check(_mfu_ok(res["mfu"]) and res["flops_per_step"] > 0,
              f"{name}: mfu {res['mfu']} outside (0, 1) or no FLOP count")
        want = {k: per_step[name].get(k, 0) * steps for k in launches}
        check(launches == want,
              f"{name}: launches {launches} in {steps} steps, want {want}")
        if name == "inception_v2":
            check(g_copies == V2_G_COPIES * steps,
                  f"inception_v2: {g_copies} gradient copies in {steps} "
                  f"steps, want {V2_G_COPIES} a step")
        out[name] = {"launches": launches, "row": row}
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 13. the recurrent path and the rest of the training loop
# --------------------------------------------------------------------------

# the PTB-LSTM configuration (`tools/bench.py --model ptb_lstm`)
PTB_VOCAB, PTB_HIDDEN, PTB_SEQ = 10001, 200, 20
# the new optimization methods held on the card against the CPU, with
# the settings of the run
NEW_METHODS = {
    "LAMB": dict(learning_rate=1e-2, weight_decay=1e-2),
    "Adagrad": dict(learning_rate=0.1, learning_rate_decay=0.01,
                    weight_decay=1e-3),
    "Adadelta": dict(decay_rate=0.9, epsilon=1e-6),
    "Adamax": dict(learning_rate=1e-2),
    "RMSprop": dict(learning_rate=1e-2, learning_rate_decay=0.01),
    "Ftrl": dict(learning_rate=0.1, l1_regularization_strength=0.01,
                 l2_regularization_strength=0.01),
}
# the example's perplexity must fall below the corpus's vocabulary size
LM_EXAMPLE_VOCAB = 200


def _all_counts(ak, sk, bk):
    """The launches of every kernel of the port, by name."""
    return {"flash_attention_fwd": ak.flash_attention_forward.launches,
            "flash_attention_carry": ak.flash_attention_carry.launches,
            "flash_attention_bwd_dq": ak.flash_attention_backward_dq.launches,
            "flash_attention_bwd_dkv":
                ak.flash_attention_backward_dkv.launches,
            "stem_conv": sk.stem_conv_forward.launches,
            "bn_relu_fwd": bk.bn_relu_forward.launches,
            "bn_relu_bwd": bk.bn_relu_backward.launches}


def _reset_all_counts(ak, sk, bk):
    _reset_flash_counts(ak)
    ak.flash_attention_carry.launches = 0
    sk.stem_conv_forward.launches = 0
    _reset_bn_counts(bk)


def _recurrent_run(model, x, y, method, dev, steps=3):
    """`steps` steps of `model` on `dev` through DistriOptimizer under
    `method` on the one batch (x, y), with the loss summed over T; the
    losses and the learning rate of every step."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer, max_iteration
    losses, lrs = [], []
    opt = DistriOptimizer(model, LocalDataSet([MiniBatch(
        torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))]),
        TimeDistributedCriterion(ClassNLLCriterion()), devices=[dev])
    rate = method.current_lr
    method.current_lr = lambda: lrs.append(rate()) or lrs[-1]
    opt.set_optim_method(method)
    opt.set_end_when(max_iteration(steps))
    opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
    opt.optimize()
    return losses, lrs


def recurrent_parity_phase():
    """13(a): f32 on the card (TF32 off) against the port on the CPU from
    the same weights and batch: PTB-LSTM at full width under SGD, then
    SimpleRNN under each new method and under SequentialSchedule(Warmup,
    Poly)."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import PTBModel, SimpleRNN

    def pair(make, x, y, method, steps=3):
        cpu = make()
        card = copy.deepcopy(cpu).cuda()
        got = _recurrent_run(card, x, y, method(), "cuda", steps)
        ref = _recurrent_run(cpu, x, y, method(), "cpu", steps)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
        params = max(float((a.detach().cpu() - b.detach()).abs().max()
                           / b.detach().abs().max().clamp(min=1e-12))
                     for a, b in zip(card.parameters(), cpu.parameters()))
        return got, ref, rel, params

    rs = np.random.RandomState(13)
    px = rs.randint(1, PTB_VOCAB, (8, PTB_SEQ)).astype(np.int32)
    py = rs.randint(1, PTB_VOCAB, (8, PTB_SEQ)).astype(np.int32)
    got, ref, rel, params = pair(
        lambda: PTBModel(PTB_VOCAB, PTB_HIDDEN, PTB_VOCAB, device="cpu",
                         generator=torch.Generator().manual_seed(0)),
        px, py, lambda: optim.SGD(learning_rate=0.01, momentum=0.9))
    print("recurrent parity " + json.dumps({
        "model": f"PTBModel({PTB_VOCAB}, {PTB_HIDDEN}, {PTB_VOCAB})",
        "batch": 8, "seq": PTB_SEQ, "steps": 3, "dtype": "float32",
        "method": "SGD(0.01, momentum 0.9)", "losses": got[0],
        "cpu_losses": ref[0], "rel_diff": rel,
        "params_rel_diff": params}), flush=True)
    check(len(got[0]) == 3 and all(np.isfinite(got[0]))
          and rel <= PARITY_RTOL,
          f"PTB f32 losses {got[0]} vs the CPU's {ref[0]}: relative "
          f"{rel:.2e} > {PARITY_RTOL}")

    sx = rs.randn(8, PTB_SEQ, 4).astype(np.float32)
    sy = rs.randint(1, 5, (8, PTB_SEQ)).astype(np.int32)

    def simple_rnn():
        return SimpleRNN(4, 40, 4, device="cpu",
                         generator=torch.Generator().manual_seed(0))

    def warmup_poly():
        sched = optim.SequentialSchedule(1)
        sched.add(optim.Warmup(0.02), 3).add(optim.Poly(1.0, 10), 10)
        return optim.SGD(0.1, momentum=0.9, learning_rate_schedule=sched)

    cases = {name: functools.partial(getattr(optim, name), **kw)
             for name, kw in NEW_METHODS.items()}
    cases["SGD + SequentialSchedule(Warmup, Poly)"] = warmup_poly
    for name, method in cases.items():
        steps = 6 if name.startswith("SGD") else 3
        got, ref, rel, params = pair(simple_rnn, sx, sy, method, steps)
        print("recurrent method " + json.dumps({
            "model": "SimpleRNN(4, 40, 4)", "method": name, "batch": 8,
            "seq": PTB_SEQ, "steps": steps, "losses": got[0],
            "cpu_losses": ref[0], "rel_diff": rel,
            "params_rel_diff": params, "lrs": got[1],
            "cpu_lrs": ref[1]}), flush=True)
        check(all(np.isfinite(got[0])) and rel <= PARITY_RTOL
              and params <= PARITY_RTOL,
              f"SimpleRNN under {name}: losses {got[0]} vs {ref[0]} "
              f"(relative {rel:.2e}), parameters {params:.2e} apart, "
              f"limit {PARITY_RTOL}")
        check(got[1] == ref[1],
              f"{name}: learning rates {got[1]} on the card, {ref[1]} on "
              "the CPU")


def ptb_bench_phase(ak, sk, bk):
    """13(b): `tools/bench.py --model ptb_lstm` for 8 warm-up and 24
    timed steps: the main path's run, every kernel count set to 0 before
    it and read after (the path runs none of the port's kernels)."""
    from bigdl_tpu_torch.tools.bench import bench_ptb_lstm
    warmup, iters, sync = 8, 24, 8
    steps = warmup + iters
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts(ak, sk, bk)
    res = bench_ptb_lstm(warmup=warmup, iters=iters, sync=sync,
                         device="cuda",
                         generator=torch.Generator().manual_seed(0))
    launches = _all_counts(ak, sk, bk)
    losses = res["losses"]
    row = {k: res[k] for k in ("model", "records_per_sec", "tokens_per_sec",
                               "ms_per_step", "flops_per_step", "mfu",
                               "batch_size", "seq", "vocab", "hidden",
                               "steps", "warmup", "sync", "device")}
    row.update({"precision": "bfloat16 compute, f32 masters",
                "loss_first": losses[0], "loss_last": losses[-1],
                "synced_losses": {i + 1: losses[i]
                                  for i in range(sync - 1, steps, sync)},
                "kernel_launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated()
                / 2 ** 30})
    print("ptb_lstm bench " + json.dumps(row), flush=True)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"ptb_lstm: non-finite or missing losses {losses}")
    lo = PTB_SEQ * math.log(PTB_VOCAB)
    check(0.9 * lo <= losses[0] <= 1.1 * lo,
          f"ptb_lstm: first loss {losses[0]} not within 10% of "
          f"T ln V = {lo:.2f}")
    check(losses[-1] < losses[0],
          f"ptb_lstm: the loss did not fall: first {losses[0]}, last "
          f"{losses[-1]}")
    check(_mfu_ok(res["mfu"]) and res["flops_per_step"] > 0,
          f"ptb_lstm: mfu {res['mfu']} outside (0, 1) or no FLOP count")
    check(not any(launches.values()),
          f"ptb_lstm launched kernels of the port: {launches}")
    return row


def lm_example_phase():
    """13(c): the example recipe (`tools/language_model.py`, its defaults:
    2 epochs of b32 over the seeded corpus, Adam 2e-3)."""
    from bigdl_tpu_torch.tools import language_model
    t0 = time.perf_counter()
    ppl = language_model.main(["--device", "cuda"])
    print(f"language model example: perplexity {ppl:.3f} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(math.isfinite(ppl) and ppl < LM_EXAMPLE_VOCAB,
          f"the example's perplexity {ppl} is not below the vocabulary's "
          f"{LM_EXAMPLE_VOCAB}")
    return ppl



# 14. data parallel: the global batch of the parity pair, its steps; the
# full-width configuration (global batch, warm-up, timed steps, sync)
DP_PARITY_BATCH, DP_PARITY_STEPS = 16, 3
DP_BATCH, DP_WARMUP, DP_ITERS, DP_SYNC = 128, 8, 16, 8
# f32 parity, several ranks against one process on the whole batch: the
# losses of every step within DP_LOSS_RTOL relative (PARITY_RTOL, phase
# 6's); after the first step, the parameters' distance from the one
# process's within DP_UPDATE_RTOL of the size of that step's update (both
# as norms over every parameter), and every BN running stat within
# DP_STAT_RTOL of its tensor's largest element. The global BN sums are the
# ranks' partial sums added and the gradients the ranks' halves averaged:
# the same f32 terms in another order. A tensor alone is no fair measure:
# the gradient of a zero-initialised residual BN's scale is a small
# difference of large sums (sum g*x - mean * sum g), which another
# summation order moves by up to 1% of its value on the card (the same
# expression as the reference's), and each later step multiplies such
# differences (in f64 on the CPU the two runs agree to 1e-12 after one
# step and 6e-9 after three). Those scales' gradients are most of the
# first update (the residual branches behind them get none), which puts
# the update's distance at 2.5e-4 on the CPU at these shapes; a wrong
# gradient (a BN statistic left local) is off by the update's own size.
# The per-tensor figures and the parameters after the last step are
# reported, not held to a limit.
DP_LOSS_RTOL = PARITY_RTOL
DP_UPDATE_RTOL = 1e-3
DP_STAT_RTOL = 1e-4
DP_CHILD_TIMEOUT_S = 600


def _dp_parity_data():
    rs = np.random.RandomState(3)
    x = rs.rand(DP_PARITY_BATCH, 224, 224, 3).astype(np.float32)
    y = (rs.randint(0, 1000, size=DP_PARITY_BATCH) + 1).astype(np.int32)
    return x, y


def _dp_f32_run(x, y):
    """ResNet-50 (seed 0) in f32 for DP_PARITY_STEPS SGD steps on the
    resident batch (x, y) through `DistriOptimizer`, deterministic: the
    losses (the ranks' mean) and the parameters and buffers (CPU) before
    the run, after the first step and after the last, and which of them
    are parameters."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    model = p11_model("cuda")
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batch = MiniBatch(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    opt = DistriOptimizer(model, LocalDataSet([batch]), ClassNLLCriterion())
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(max_iteration(DP_PARITY_STEPS))
    losses, first = [], {}

    def hook(st):
        losses.append(st["loss"])
        if st["neval"] == 1:
            first.update({k: v.detach().cpu().clone()
                          for k, v in model.state_dict().items()})

    opt.set_iteration_hook(hook)
    with Deterministic():
        opt.optimize()
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    names = [k for k, _ in model.named_parameters()]
    del model, opt, batch
    torch.cuda.empty_cache()
    return losses, {"init": init, "first": first, "last": state,
                    "params": names}


def dp_child(out_dir, backend, full):
    """A rank of phase 14(b, c), started by `dp_launch`: joins the group
    from the launcher's environment, runs the f32 parity on its shard,
    then (with `full`) the full-width bf16 configuration; writes its
    results to `out_dir`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bigdl_tpu_torch.parallel import collectives
    from bigdl_tpu_torch.tools import bench
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init(distributed=True, backend=backend)
    rank, world = collectives.rank(), collectives.world_size()
    x, y = _dp_parity_data()
    local = DP_PARITY_BATCH // world
    rows = slice(rank * local, (rank + 1) * local)
    collectives.reset_counts()
    losses, state = _dp_f32_run(x[rows], y[rows])
    out = {"rank": rank, "world": world, "backend": backend,
           "device": str(Engine.device), "parity_losses": losses,
           "parity_collectives": dict(collectives.counts)}
    if rank == 0:
        torch.save(state, os.path.join(out_dir, "parity_state.pt"))
    if full == "1":
        out["full"] = bench.resnet50_rank(DP_BATCH, DP_WARMUP, DP_ITERS,
                                          DP_SYNC, device=Engine.device)
    Engine.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def dp_launch(tmp, world, backend, full):
    """Start `world` ranks of `chip_smoke.py --dp-child` (rank r on
    cuda:{r % device_count}), wait for all of them, and return their
    results and the wall time; any rank that fails or outlives
    DP_CHILD_TIMEOUT_S fails the phase (every rank is stopped)."""
    import socket
    out_dir = os.path.join(tmp, f"dp-{backend}-{world}")
    os.makedirs(out_dir)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-child",
             out_dir, backend, "1" if full else "0"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"data-parallel rank {r}/{world} "
              f"({backend}) failed (exit {p.returncode}):\n{log[-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    state = torch.load(os.path.join(out_dir, "parity_state.pt"))
    return ranks, state, seconds


def _max_rel(a, b):
    """The largest |a - b| of each tensor over its largest |b|; the worst
    tensor's name and value."""
    worst = ("", 0.0)
    for k in b:
        if not b[k].is_floating_point():
            continue
        d = float((a[k].float() - b[k].float()).abs().max()) / max(
            float(b[k].float().abs().max()), 1e-30)
        if d > worst[1]:
            worst = (k, d)
    return worst


def _update_rel(got, want, init, names):
    """|got - want| over |want - init|, as norms over the tensors `names`:
    the distance between two runs' parameters relative to the size of the
    update they made."""
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in names)
    den = sum(float((want[k] - init[k]).double().pow(2).sum())
              for k in names)
    return math.sqrt(num / max(den, 1e-300))


def _dp_parity_check(label, ranks, state, ref_losses, ref_state):
    """Every rank's losses and rank 0's parameters and BN running stats
    against the one-process run; prints and checks them."""
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["parity_losses"], ref_losses))
    names = ref_state["params"]
    buffers = [k for k in ref_state["first"] if k not in names]
    update = _update_rel(state["first"], ref_state["first"],
                         ref_state["init"], names)
    update_last = _update_rel(state["last"], ref_state["last"],
                              ref_state["init"], names)
    stats = _max_rel({k: state["first"][k] for k in buffers},
                     {k: ref_state["first"][k] for k in buffers})
    worst = _max_rel({k: state["first"][k] for k in names},
                     {k: ref_state["first"][k] for k in names})
    last = _max_rel(state["last"], ref_state["last"])
    print(f"data parallel parity {label} " + json.dumps({
        "world": len(ranks), "backend": ranks[0]["backend"],
        "global_batch": DP_PARITY_BATCH, "steps": DP_PARITY_STEPS,
        "dtype": "float32", "losses": [r["parity_losses"] for r in ranks],
        "one_process_losses": ref_losses, "loss_max_rel_diff": rel,
        "update_rel_diff_step1": update, "update_rel_diff_last": update_last,
        "bn_stat_max_rel_diff_step1": stats[1], "worst_stat": stats[0],
        "param_max_rel_diff_step1": worst[1], "worst_tensor": worst[0],
        "param_max_rel_diff_last": last[1], "worst_tensor_last": last[0],
        "collectives": ranks[0]["parity_collectives"],
        "devices": [r["device"] for r in ranks]}), flush=True)
    check(all(len(r["parity_losses"]) == DP_PARITY_STEPS
              and all(np.isfinite(r["parity_losses"])) for r in ranks),
          f"{label}: losses {[r['parity_losses'] for r in ranks]}")
    check(rel <= DP_LOSS_RTOL, f"{label}: losses {rel:.2e} relative from "
          f"the one-process run (> {DP_LOSS_RTOL})")
    check(update <= DP_UPDATE_RTOL, f"{label}: the parameters after step 1 "
          f"are {update:.2e} of the step's update from the one-process run "
          f"(> {DP_UPDATE_RTOL})")
    check(stats[1] <= DP_STAT_RTOL, f"{label}: {stats[0]} {stats[1]:.2e} of "
          f"its largest element from the one-process run (> {DP_STAT_RTOL})")
    return {"loss_max_rel_diff": rel, "update_rel_diff_step1": update,
            "bn_stat_max_rel_diff_step1": stats[1],
            "param_max_rel_diff_step1": worst[1],
            "param_max_rel_diff_last": last[1]}


def dp_one_rank_phase(bk):
    """(a): the benchmark configuration under an NCCL group of world size 1
    against phase 6's path without a group: no collective, the same
    losses and parameters."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.parallel import collectives
    from bigdl_tpu_torch.tools import bench
    from bigdl_tpu_torch.utils.engine import Engine
    steps = 4
    x, y = bench._image_batch((224, 224, 3), 1000, DP_BATCH)

    def run():
        model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                         generator=torch.Generator().manual_seed(0))
        opt = bench._resident_optimizer(model, x, y, ClassNLLCriterion(),
                                        torch.device("cuda"))
        opt.set_end_when(max_iteration(steps))
        losses = []
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        with Deterministic():
            opt.optimize()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model, opt
        torch.cuda.empty_cache()
        return losses, state

    ref_losses, ref_state = run()
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    Engine.init(distributed=True, coordinator_address=f"127.0.0.1:{port}",
                num_processes=1, process_id=0)
    try:
        backend = torch.distributed.get_backend()
        collectives.reset_counts()
        _reset_bn_counts(bk)
        losses, state = run()
        issued = dict(collectives.counts)
        launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    finally:
        Engine.shutdown()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    worst = _max_rel(state, ref_state)
    print("data parallel one rank " + json.dumps({
        "backend": backend, "world": 1, "batch": DP_BATCH, "steps": steps,
        "precision": "bfloat16 compute, f32 masters", "losses": losses,
        "no_group_losses": ref_losses, "loss_max_rel_diff": rel,
        "param_max_rel_diff": worst[1], "collectives": issued,
        "launches": launches}), flush=True)
    check(backend == "nccl", f"the one-rank group is {backend}, not nccl")
    check(not issued, f"world size 1 issued collectives: {issued}")
    check(rel <= PARITY_RTOL and worst[1] <= PARITY_RTOL,
          f"world size 1 against no group: losses {rel:.2e}, {worst[0]} "
          f"{worst[1]:.2e} (> {PARITY_RTOL})")
    check(launches == (BN_SITES * steps,) * 2,
          f"BN+ReLU launches {launches} in {steps} steps")


def dp_phase(bk, tmp):
    """(b) two ranks over gloo sharing the card, (c) NCCL over the cards
    when there are several. Returns each rank's full-width figures."""
    x, y = _dp_parity_data()
    torch.cuda.empty_cache()
    ref_losses, ref_state = _dp_f32_run(x, y)
    ranks, state, seconds = dp_launch(tmp, 2, "gloo", full=True)
    _dp_parity_check("gloo 2 ranks on one card", ranks, state, ref_losses,
                     ref_state)
    full = [r["full"] for r in ranks]
    for f in full:
        print("data parallel gloo rank " + json.dumps({
            **{k: v for k, v in f.items() if k != "losses"},
            "loss_first": f["losses"][0], "loss_last": f["losses"][-1],
            "note": "two ranks sharing one card through host-staged gloo: "
                    "a check that the path works, not a scaling figure"}),
            flush=True)
        steps = DP_WARMUP + DP_ITERS
        check(len(f["losses"]) == steps and all(np.isfinite(f["losses"]))
              and f["losses"][-1] < f["losses"][0],
              f"rank {f['rank']}: losses {f['losses']}")
        check(f["bn_relu_launches_per_step"] == {"fwd": BN_SITES,
                                                 "bwd": BN_SITES},
              f"rank {f['rank']}: BN+ReLU launches a step "
              f"{f['bn_relu_launches_per_step']}, not {BN_SITES}")
        per = f["collectives_per_step"]
        check(per.get("grad") == f["n_buckets"] and per.get("bn") == 212,
              f"rank {f['rank']}: collectives a step {per}, "
              f"{f['n_buckets']} buckets")
    print(f"data parallel gloo launch: {seconds:.1f} s", flush=True)
    n = min(torch.cuda.device_count(), 4)
    multi = None
    if n >= 2:
        ranks, state, seconds = dp_launch(tmp, n, "nccl", full=True)
        multi = _dp_parity_check(f"nccl {n} cards", ranks, state,
                                 ref_losses, ref_state)
        for r in ranks:
            print("data parallel nccl rank " + json.dumps(
                {k: v for k, v in r["full"].items() if k != "losses"}),
                flush=True)
        multi["imgs_per_sec"] = DP_BATCH / max(
            r["full"]["ms_per_step"] for r in ranks) * 1e3
    else:
        print("data parallel over several cards: not measured (this "
              f"machine has {torch.cuda.device_count()} card)", flush=True)
    return full, multi


# 16. tensor parallelism: (a)'s sequence, global batch, steps and the step
# of (c)'s checkpoint; (b)'s warm-up, timed steps and sync; the limit
# against one process (the global batch's sums in another order: two
# replicas' halves averaged); the children's time limit
TP_SEQ, TP_BATCH, TP_STEPS, TP_SAVE_AT = 256, 8, 4, 2
TP_WARMUP, TP_ITERS, TP_SYNC = 2, 6, 2
TP_RTOL = 1e-5
TP_CHILD_TIMEOUT_S = 300


def _tp_backend(world):
    """NCCL with one rank a card where the machine has enough cards, else
    gloo with the ranks sharing the card."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _tp_batch():
    rs = np.random.RandomState(4)
    toks = rs.randint(1, LM_CFG["vocab_size"] + 1,
                      (TP_BATCH, TP_SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _tp_run(mesh, x, y, ckpt=None, resume=False, on_step=None):
    """The f32 LM (seed 0) for TP_STEPS SGD steps (0.01, momentum 0.9) on
    the resident batch (x, y) through `DistriOptimizer` on `mesh` (None:
    no model axis), deterministic; with `ckpt`, a sharded checkpoint at
    step TP_SAVE_AT (`resume`: resumed from it first). The losses and the
    parameters after the run (CPU)."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    batch = MiniBatch(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    opt = DistriOptimizer(model, LocalDataSet([batch]),
                          TimeDistributedCriterion(ClassNLLCriterion(),
                                                   size_average=True),
                          mesh=mesh)
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(max_iteration(TP_STEPS))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, lambda st: st["neval"] == TP_SAVE_AT,
                           sharded=True)
    if resume:
        check(opt.resume_from_latest_checkpoint(),
              f"nothing to resume from in {ckpt}")
    losses = []

    def hook(st):
        losses.append(st["loss"])
        if on_step is not None:
            on_step(opt, st)

    opt.set_iteration_hook(hook)
    with Deterministic():
        opt.optimize()
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, opt, batch
    torch.cuda.empty_cache()
    return losses, state


def tp_child(out_dir, mode, backend):
    """A rank of phase 16(a, c), started by `tp_launch`: "tp" trains on the
    (2, 2) mesh and saves the sharded checkpoint, "dp" trains on (2, 1)
    and restores that checkpoint, "resume" resumes from it on (2, 2).
    Writes its results to `out_dir`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.parallel import collectives
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init(distributed=True, backend=backend)
    rank, world = collectives.rank(), collectives.world_size()
    mesh = Engine.get_mesh(data=2, model=world // 2)
    x, y = _tp_batch()
    local = TP_BATCH // 2
    rows = slice(mesh.data_index * local, (mesh.data_index + 1) * local)
    ckpt = os.path.join(out_dir, "ckpt")
    out = {"rank": rank, "world": world, "backend": backend,
           "coords": [mesh.data_index, mesh.model_index],
           "device": str(Engine.device)}
    stored, at_save = {}, {}

    def note(opt, st):
        if st["neval"] == 1 and opt.sharded is not None:
            stored.update({n: [list(p.shape),
                               list(opt.sharded.full_shapes[n])]
                           for n, p in opt.model.named_parameters()
                           if n in opt.sharded.dims})
        if st["neval"] == TP_SAVE_AT and opt.sharded is None:
            at_save.update({k: v.detach().cpu().clone()
                            for k, v in opt.model.state_dict().items()})

    _reset_flash_counts(ak)
    losses, state = _tp_run(mesh, x[rows], y[rows],
                            ckpt=ckpt if mode != "dp" else None,
                            resume=mode == "resume", on_step=note)
    out.update(losses=losses, stored=stored,
               launches=dict(zip(("fwd", "dq", "dkv"), _flash_counts(ak))))
    if mode == "dp":
        # (c): the (2, 2) checkpoint restored on (2, 1)
        from bigdl_tpu_torch.models import TransformerLM
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        from bigdl_tpu_torch.optim import DistriOptimizer
        from bigdl_tpu_torch.dataset import LocalDataSet
        model = TransformerLM(**LM_CFG, device="cuda",
                              generator=torch.Generator().manual_seed(1))
        opt = DistriOptimizer(model, LocalDataSet([]), ClassNLLCriterion(),
                              mesh=mesh)
        opt.set_checkpoint(ckpt, lambda st: False, sharded=True)
        check(opt.resume_from_latest_checkpoint(), "no checkpoint on (2, 1)")
        got = model.state_dict()
        out["restored_bitwise"] = all(torch.equal(got[k].cpu(), v)
                                      for k, v in at_save.items()) \
            and set(got) == set(at_save) and bool(at_save)
        if rank == 0:
            torch.save(at_save, os.path.join(out_dir, "dp_at_save.pt"))
    if rank == 0:
        torch.save(state, os.path.join(out_dir, f"{mode}_state.pt"))
    Engine.shutdown()
    with open(os.path.join(out_dir, f"{mode}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def tp_launch(tmp, *jobs):
    """Start every (world, mode) of `jobs` together, each `world` ranks of
    `chip_smoke.py --tp-child` in `mode` (rank r on cuda:{r %
    device_count}), and wait for all of them; for each job, its ranks'
    results and rank 0's parameters after the run. A rank that fails or
    outlives TP_CHILD_TIMEOUT_S fails the phase (every rank is
    stopped)."""
    import socket
    t0 = time.perf_counter()
    procs = []
    for world, mode in jobs:
        backend = _tp_backend(world)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for r in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_RANK=str(r))
            log = open(os.path.join(tmp, f"{mode}-rank{r}.log"), "w+")
            procs.append((f"{mode} rank {r}/{world} ({backend})", log,
                          subprocess.Popen(
                              [sys.executable, os.path.abspath(__file__),
                               "--tp-child", tmp, mode, backend], env=env,
                              stdout=log, stderr=subprocess.STDOUT)))
    try:
        deadline = time.monotonic() + TP_CHILD_TIMEOUT_S
        for _, _, p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        texts = []
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            texts.append(log.read())
            log.close()
    for (what, _, p), text in zip(procs, texts):
        check(p.returncode == 0, f"tensor-parallel {what} failed (exit "
              f"{p.returncode}):\n{text[-3000:]}")
    print(f"tensor parallel launch {[m for _, m in jobs]}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = []
    for world, mode in jobs:
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"{mode}-rank{r}.json")) as f:
                ranks.append(json.load(f))
        out.append((ranks, torch.load(os.path.join(tmp,
                                                   f"{mode}_state.pt"))))
    return out


def _half_on_one_axis(got, full):
    """Whether shape `got` is `full` with exactly one axis halved."""
    diff = [(g, f) for g, f in zip(got, full) if g != f]
    return len(got) == len(full) and len(diff) == 1 \
        and 2 * diff[0][0] == diff[0][1]


def _tp_bitwise(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)


def tp_parity_phase(tmp):
    """(a) and (c); returns (a)'s figures."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serialization.sharded_checkpoint import \
        load_checkpoint_sharded
    from bigdl_tpu_torch.interop import load_params
    x, y = _tp_batch()
    ref_losses, ref_state = _tp_run(None, x, y)
    (tp, tp_state), = tp_launch(tmp, (4, "tp"))
    # both only read (a)'s checkpoint: one launch of six processes
    (dp, dp_state), (resumed, resumed_state) = tp_launch(
        tmp, (2, "dp"), (4, "resume"))
    # (a)
    bitwise_losses = all(r["losses"] == dp[r["coords"][0]]["losses"]
                         for r in tp)
    bitwise_params = _tp_bitwise(tp_state, dp_state)
    rel = max(abs(a - b) / abs(b) for r in tp
              for a, b in zip(r["losses"], ref_losses))
    worst = _max_rel(tp_state, ref_state)
    halves = all(_half_on_one_axis(got, full)
                 for r in tp for got, full in r["stored"].values())
    out = {"mesh": [2, 2], "backend": tp[0]["backend"], "seq": TP_SEQ,
           "global_batch": TP_BATCH, "steps": TP_STEPS, "dtype": "float32",
           "losses": [r["losses"] for r in tp],
           "dp_losses": [r["losses"] for r in dp],
           "one_process_losses": ref_losses,
           "losses_bitwise_vs_2x1": bitwise_losses,
           "params_bitwise_vs_2x1": bitwise_params,
           "loss_max_rel_diff_vs_one_process": rel,
           "param_max_rel_diff_vs_one_process": worst[1],
           "worst_tensor": worst[0],
           "sharded_params": len(tp[0]["stored"]),
           "stored_halves": halves,
           "launches_per_rank": [r["launches"] for r in tp],
           "devices": [r["device"] for r in tp]}
    print("tensor parallel parity " + json.dumps(out), flush=True)
    check(all(r["device"].startswith("cuda") for r in tp + dp + resumed),
          f"a rank ran off the card: {[r['device'] for r in tp + dp]}")
    check(bitwise_losses and bitwise_params,
          "(2, 2) against (2, 1): not bitwise (losses "
          f"{bitwise_losses}, parameters {bitwise_params})")
    check(all(np.isfinite(r["losses"]).all() for r in tp)
          and rel <= TP_RTOL and worst[1] <= TP_RTOL,
          f"(2, 2) against one process: losses {rel:.2e}, {worst[0]} "
          f"{worst[1]:.2e} (> {TP_RTOL})")
    check(len(tp[0]["stored"]) == 26 and halves,
          f"sharded parameters stored on a rank: {tp[0]['stored']}")
    want = {k: LM_LAYERS * TP_STEPS for k in ("fwd", "dq", "dkv")}
    check(all(r["launches"] == want for r in tp + dp),
          f"flash launches per rank {[r['launches'] for r in tp + dp]}, "
          f"not {want}")
    # (c)
    first = {tuple(r["coords"]): r["losses"] for r in tp}
    resume_ok = all(r["losses"] == first[tuple(r["coords"])][TP_SAVE_AT:]
                    for r in resumed)
    resume_params = _tp_bitwise(resumed_state, tp_state)
    at_save = torch.load(os.path.join(tmp, "dp_at_save.pt"))
    params, mstate, blob = load_checkpoint_sharded(
        os.path.join(tmp, "ckpt", f"iter{TP_SAVE_AT}"))
    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(1))
    load_params(model, params, mstate)
    one = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    restored = {"resumed_losses": [r["losses"] for r in resumed],
                "resume_losses_bitwise": resume_ok,
                "resume_params_bitwise": resume_params,
                "restored_2x1_bitwise": [r["restored_bitwise"] for r in dp],
                "restored_one_process_bitwise": _tp_bitwise(one, at_save),
                "checkpoint_neval": blob["state"]["neval"],
                "checkpoint_files": sorted(os.listdir(os.path.join(
                    tmp, "ckpt", f"iter{TP_SAVE_AT}", "arrays")))}
    print("tensor parallel sharded checkpoint " + json.dumps(restored),
          flush=True)
    check(resume_ok and resume_params,
          "the fresh (2, 2) launch did not resume bitwise "
          f"(losses {resume_ok}, parameters {resume_params})")
    check(all(restored["restored_2x1_bitwise"])
          and restored["restored_one_process_bitwise"],
          "the sharded checkpoint did not restore bitwise on (2, 1) or in "
          "one process")
    return out


def tp_bench_phase():
    """(b): `tools/bench.py --model lm --nproc 4 --model-axis 2`. Returns
    each rank's launches of kernels 1, 3 and 4 over the run."""
    from bigdl_tpu_torch.tools.bench import bench_dp
    backend = _tp_backend(4)
    res = bench_dp("lm", 4, batch_size=8, warmup=TP_WARMUP, iters=TP_ITERS,
                   sync=TP_SYNC, backend=backend, device="cuda",
                   timeout_s=TP_CHILD_TIMEOUT_S, model_axis=2)
    ranks = res["ranks"]
    keep = ("rank", "coords", "ms_per_step", "tokens_per_sec",
            "collectives_per_step", "n_buckets", "stored_param_bytes",
            "stored_bytes", "flash_launches_per_step", "flops_per_step")
    print("tensor parallel lm " + json.dumps({
        **{k: v for k, v in res.items() if k != "ranks"},
        "seq": ranks[0]["seq"], "precision": "bfloat16 compute, f32 masters",
        "clip_l2": 1.0, "sharded_params": len(ranks[0]["sharded"]),
        "ranks": [{k: r[k] for k in keep} for r in ranks],
        "note": "four ranks sharing one card through host-staged gloo: a "
                "check that the path works, not a scaling figure"
                if backend == "gloo" else "one rank a card over NCCL"}),
        flush=True)
    want = {k: LM_LAYERS for k in ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv")}
    for r in ranks:
        losses = r["losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"tensor-parallel lm rank {r['rank']}: losses {losses}")
        check(r["flash_launches_per_step"] == want,
              f"tensor-parallel lm rank {r['rank']}: flash launches a step "
              f"{r['flash_launches_per_step']}, not {want}")
        per = r["collectives_per_step"]
        check(per.get("gather") == 26 and per.get("grad") == r["n_buckets"],
              f"tensor-parallel lm rank {r['rank']}: collectives a step "
              f"{per}")
    steps = TP_WARMUP + TP_ITERS
    return {k: [int(r["kernel_launches_per_step"][k] * steps) for r in ranks]
            for k in want}


# 15. Wide&Deep (`BASELINE.md` config 5): the f32 pair's steps and limits;
# the benchmark's warm-up, timed steps and sync; the served requests; the
# example's accuracy floor
WD_PARITY_STEPS, WD_PARITY_RTOL = 8, 1e-5
WD_WARMUP, WD_ITERS, WD_SYNC = 8, 24, 8
WD_REQUESTS, WD_SERVE_ATOL = 64, 1e-6
WD_EXAMPLE_ACC = 0.85


def _wd_run(model, x, y, dev, steps):
    """`steps` SGD steps (0.01, momentum 0.9) of `model` on `dev` through
    DistriOptimizer in f32 on the one four-tensor batch; the losses."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    batch = MiniBatch([torch.from_numpy(v).to(dev) for v in x],
                      torch.from_numpy(y).to(dev))
    opt = DistriOptimizer(model, LocalDataSet([batch]), ClassNLLCriterion(),
                          devices=[dev])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(max_iteration(steps))
    losses = []
    opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
    opt.optimize()
    return losses


def wd_parity_phase():
    """15(a): config 5 at b1024 in f32 on the card (TF32 off) against the
    same model on the CPU, from one seed, for 8 SGD steps: losses within
    a relative 1e-5, each parameter within 1e-5 of its tensor's largest
    element (the embedding backward's atomics add in another order)."""
    from bigdl_tpu_torch.tools import bench
    x, y = bench._wide_n_deep_batch(bench.WIDE_N_DEEP["batch_size"])
    cpu = bench.wide_n_deep_model("cpu", torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).cuda()
    got = _wd_run(card, x, y, "cuda", WD_PARITY_STEPS)
    ref = _wd_run(cpu, x, y, "cpu", WD_PARITY_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    params = max(float((a.detach().cpu() - b.detach()).abs().max()
                       / b.detach().abs().max().clamp(min=1e-12))
                 for a, b in zip(card.parameters(), cpu.parameters()))
    print("wide_n_deep parity " + json.dumps({
        "batch": len(y), "steps": WD_PARITY_STEPS, "dtype": "float32",
        "losses": got, "cpu_losses": ref, "rel_diff": rel,
        "params_rel_diff": params}), flush=True)
    check(len(got) == WD_PARITY_STEPS and all(np.isfinite(got))
          and rel <= WD_PARITY_RTOL and params <= WD_PARITY_RTOL,
          f"wide_n_deep f32: losses {got} vs the CPU's {ref} (relative "
          f"{rel:.2e}), parameters {params:.2e} apart, limit "
          f"{WD_PARITY_RTOL}")


def wd_bench_phase(ak, sk, bk):
    """15(b, d): `tools/bench.py --model wide_n_deep` (b1024, bf16 compute
    with f32 masters) for 8 warm-up and 24 timed steps: the main path's
    run, every kernel count set to 0 before it and read after (the path
    runs none of the port's kernels)."""
    from bigdl_tpu_torch.tools.bench import bench_wide_n_deep
    steps = WD_WARMUP + WD_ITERS
    _reset_all_counts(ak, sk, bk)
    res = bench_wide_n_deep(warmup=WD_WARMUP, iters=WD_ITERS, sync=WD_SYNC,
                            device="cuda",
                            generator=torch.Generator().manual_seed(0))
    launches = _all_counts(ak, sk, bk)
    losses = res["losses"]
    row = {k: res[k] for k in ("model", "records_per_sec", "ms_per_step",
                               "flops_per_step", "mfu", "batch_size",
                               "steps", "warmup", "sync", "device")}
    row.update({"precision": "bfloat16 compute, f32 masters",
                "losses": losses, "kernel_launches": launches})
    print("wide_n_deep bench " + json.dumps(row), flush=True)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"wide_n_deep: non-finite or missing losses {losses}")
    check(losses[-1] < losses[0],
          f"wide_n_deep: the loss did not fall: first {losses[0]}, last "
          f"{losses[-1]}")
    check(_mfu_ok(res["mfu"]) and res["flops_per_step"] > 0,
          f"wide_n_deep: mfu {res['mfu']} outside (0, 1) or no FLOP count")
    check(not any(launches.values()),
          f"wide_n_deep launched kernels of the port: {launches}")
    return row


def wd_profile_phase():
    """15(c): where the b1024 bf16 step's time goes (`--profile`)."""
    from bigdl_tpu_torch.tools.bench import profile_wide_n_deep
    res = profile_wide_n_deep(generator=torch.Generator().manual_seed(0))
    print("wide_n_deep profile " + json.dumps(res), flush=True)
    check(res["kernel_launches_per_step"] > 0
          and res["device_busy_ms_per_step"] > 0,
          f"wide_n_deep profile saw no device work: {res}")
    return res


def wd_example_phase():
    """15(e): the example (`tools/wide_n_deep.py` at its defaults) on the
    card: train accuracy of `wide_n_deep` at least 0.85."""
    from bigdl_tpu_torch.tools import wide_n_deep
    t0 = time.perf_counter()
    acc = wide_n_deep.main(["--device", "cuda"])
    print(f"wide_n_deep example: train accuracy {acc} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(acc >= WD_EXAMPLE_ACC,
          f"the example's train accuracy {acc} < {WD_EXAMPLE_ACC}")
    return acc


def wd_serving_phase():
    """15(f): 64 four-feature requests through `InferenceEngine` (the
    model behind a `ConcatTable` of two views, so the engine must give
    `y[1]`): each output within 1e-6 of the model's own b64 forward and
    equal to `LocalPredictor`'s."""
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import LocalPredictor
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.tools import bench
    from bigdl_tpu_torch.utils import T
    wd = bench.wide_n_deep_model("cuda", torch.Generator().manual_seed(0))
    served = (tnn.Sequential().add(wd).add(
        tnn.ConcatTable().add(tnn.Identity()).add(tnn.Identity())))
    x, _ = bench._wide_n_deep_batch(WD_REQUESTS, seed=15)
    samples = [Sample([v[i] for v in x]) for i in range(WD_REQUESTS)]
    with torch.no_grad():
        want = wd.eval()(T(*[torch.from_numpy(v).cuda() for v in x])).cpu()
    pred = np.stack(LocalPredictor(served, batch_size=WD_REQUESTS,
                                   device="cuda").predict(samples))
    with InferenceEngine(served, max_batch_size=32, max_wait_ms=2.0,
                         device="cuda") as eng:
        futs = [eng.submit(s) for s in samples]
        got = np.stack([f.result(120) for f in futs])
        stats = eng.stats()
    err = float(np.abs(got - want.numpy()).max())
    err_pred = float(np.abs(pred - want.numpy()).max())
    print("wide_n_deep serving " + json.dumps({
        "requests": WD_REQUESTS, "max_abs_err": err,
        "predictor_max_abs_err": err_pred,
        "batches": stats["batches"], "completed": stats["completed"]}),
        flush=True)
    check(got.shape == (WD_REQUESTS, 2) and err <= WD_SERVE_ATOL
          and err_pred <= WD_SERVE_ATOL,
          f"wide_n_deep served outputs {err:.2e} (predictor "
          f"{err_pred:.2e}) from the b64 forward, limit {WD_SERVE_ATOL}")


def wd_dp_phase():
    """15(g): `tools/bench.py --model wide_n_deep --nproc 2 --backend
    gloo`: two ranks sharing the card, b512 each: each rank's loss falls,
    one gradient all-reduce a step (one bucket), no kernel launch."""
    from bigdl_tpu_torch.tools.bench import bench_dp
    res = bench_dp("wide_n_deep", 2, warmup=WD_WARMUP, iters=16,
                   sync=WD_SYNC, backend="gloo", device="cuda",
                   timeout_s=DP_CHILD_TIMEOUT_S)
    print("wide_n_deep dp " + json.dumps(
        {**{k: v for k, v in res.items() if k != "ranks"},
         "ranks": [{k: v for k, v in r.items() if k != "losses"}
                   for r in res["ranks"]],
         "rank_losses": [[r["losses"][0], r["losses"][-1]]
                         for r in res["ranks"]]}), flush=True)
    for r in res["ranks"]:
        losses = r["losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"wide_n_deep rank {r['rank']}: the loss did not fall "
              f"({losses[0]} -> {losses[-1]})")
        check(r["collectives_per_step"].get("grad") == 1.0
              and r["n_buckets"] == 1,
              f"wide_n_deep rank {r['rank']}: gradient all-reduces "
              f"{r['collectives_per_step']}, {r['n_buckets']} buckets")
        check(not any(r["kernel_launches_per_step"].values()),
              f"wide_n_deep rank {r['rank']} launched kernels of the port: "
              f"{r['kernel_launches_per_step']}")
    return res


# --------------------------------------------------------------------------
# 17. the observability core on the main paths
# --------------------------------------------------------------------------

# (a): the LM recipe of phase 8 for [clean, clean, poisoned, clean, clean]
# under a skipping NaN guard, every step a sync point
P17_STEPS = 5
P17_POISON = 3
# (d): plain and instrumented runs in turns (plain first), each over a
# fresh copy of the same weights: warm-up, then timed steps, syncing every
# `sync` (the median window after the warm-up)
P17_TURNS = 2
P17_COST = dict(warmup=4, iters=12, sync=4)


def _gated_lm(**kw):
    """Phase 17(a)'s LM: `TransformerLM` taking the 1-based `Table` (ids,
    gate), the gate [B, 1, 1] f32 multiplied into the embeddings. Token
    ids cannot carry a NaN; the gate is 1.0 on a clean batch (x * 1.0 is
    x, in bf16 too) and NaN on the poisoned one."""
    from bigdl_tpu_torch.models import TransformerLM

    class GatedLM(TransformerLM):
        def forward(self, inp):
            x = self._embed(inp[1]) * inp[2]
            for blk in self.blocks:
                x = blk(x)
            return torch.log_softmax(x @ self.head, dim=-1)

    return GatedLM(**kw)


class _Resident:
    """A dataset of resident batches fed in order, looping (no shuffle)."""

    def __init__(self, batches):
        self.batches = batches

    def data(self, train):
        def looped():
            while True:
                yield from self.batches
        return looped() if train else iter(self.batches)

    def size(self):
        return sum(b.size() for b in self.batches)

    def shuffle(self):
        pass


def _instrument(opt, sink, tmp, **tel):
    """Phase 17's instrumentation on `opt`: a `Telemetry` with the grad
    norms (a JSONL file under `tmp` and `sink`), a `SpanTracer`, a
    skipping `NanGuard`, a `StragglerDetector` and a `ThroughputMonitor`.
    Returns the tracer."""
    from bigdl_tpu_torch.observability import (FlightRecorder, JsonlSink,
                                               NanGuard, SpanTracer,
                                               StragglerDetector, Telemetry,
                                               ThroughputMonitor)
    tracer = SpanTracer(process_name="chip_smoke phase 17")
    sinks = [sink] if tmp is None else [
        JsonlSink(os.path.join(tmp, "run.jsonl")), sink]
    opt.set_telemetry(Telemetry(*sinks, grad_norms=True,
                                flight=FlightRecorder(dump_dir=tmp), **tel))
    opt.set_tracer(tracer)
    opt.set_health_monitors(NanGuard("skip"), StragglerDetector(),
                            ThroughputMonitor())
    return tracer


def _lm_guard_run(batches, steps, keep_at, sink=None, tmp=None):
    """The LM recipe (phase 8: b8 T=2048, bf16 compute with f32 masters,
    SGD momentum 0.9, the loss summed over T) over `batches` for `steps`
    steps, weights from seed 0, under `NanGuard("skip")` (and, with
    `sink`, the whole instrumentation). Returns the optimizer, the
    tracer, every step's synced loss and host copies of the parameters
    and the momentum after step `keep_at`."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.observability import NanGuard
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    model = _gated_lm(**LM_CFG, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    opt = DistriOptimizer(model, _Resident(batches),
                          TimeDistributedCriterion(ClassNLLCriterion()),
                          devices=["cuda"])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_end_when(max_iteration(steps))
    tracer = None
    if sink is not None:
        tracer = _instrument(opt, sink, tmp)
    else:
        opt.set_health_monitors(NanGuard("skip"))
    losses, kept = [], {}

    def hook(state):
        losses.append(state["loss"])
        if state["neval"] == keep_at:
            kept["params"] = {k: p.detach().cpu().clone()
                              for k, p in model.named_parameters()}
            kept["velocity"] = {k: v.cpu().clone() for k, v in
                                opt.opt_state["velocity"].items()}

    opt.set_iteration_hook(hook)
    opt.optimize()
    return opt, tracer, losses, kept


def _strict_json_lines(path):
    """Every line of a JSONL file parsed as strict JSON (a bare NaN or
    Infinity token fails)."""
    def refuse(token):
        raise ValueError(f"non-strict JSON token {token}")

    with open(path) as f:
        return [json.loads(line, parse_constant=refuse) for line in f]


def observed_lm_phase(ak, tmp):
    """17(a). Returns the launches of kernels 1, 3 and 4."""
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.observability import InMemorySink, validate_record
    from bigdl_tpu_torch.tools.bench import _token_batch
    x, y = _token_batch(LM_CFG["vocab_size"], 2048, 8)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    clean = MiniBatch([x, torch.ones(8, 1, 1, device="cuda")], y)
    bad = MiniBatch([x, torch.full((8, 1, 1), float("nan"),
                                   device="cuda")], y)
    stream = [bad if i + 1 == P17_POISON else clean
              for i in range(P17_STEPS)]
    sink = InMemorySink()
    with Deterministic() as det:
        _reset_flash_counts(ak)
        t0 = time.perf_counter()
        opt, tracer, losses, skipped = _lm_guard_run(
            stream, P17_STEPS, P17_POISON, sink, tmp)
        run_s = time.perf_counter() - t0
        counts = _flash_counts(ak)
        opt.telemetry.close()
        trace_path = opt.export_trace(os.path.join(tmp, "trace.json"))
        del opt
        torch.cuda.empty_cache()
        _, _, clean_losses, want = _lm_guard_run(
            [clean], P17_POISON - 1, P17_POISON - 1)
    torch.cuda.empty_cache()
    recs = sink.records
    for r in recs:
        validate_record(r)
    on_disk = _strict_json_lines(os.path.join(tmp, "run.jsonl"))
    steps = [r for r in recs if r["type"] == "step"]
    events = [r for r in recs if r["type"] == "event"]
    with open(trace_path) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"}
    diff = {}
    for part in ("params", "velocity"):
        for k, v in want[part].items():
            d = float((skipped[part][k] - v).abs().max())
            if d or not torch.equal(skipped[part][k], v):
                diff[f"{part}/{k}"] = d
    rtol = NONDET_RTOL if det.ops else 0.0
    rel = max((float((skipped[p][k] - v).abs().max())
               / max(float(v.abs().max()), 1e-30))
              for p in ("params", "velocity") for k, v in want[p].items())
    out = {"batch": 8, "seq": 2048, "steps": P17_STEPS,
           "poisoned_step": P17_POISON, "losses": losses,
           "clean_losses": clean_losses,
           "nonfinite_steps": [r.get("nonfinite_steps") for r in steps],
           "grad_norms": [r.get("grad_norm") for r in steps],
           "param_norms": [r.get("param_norm") for r in steps],
           "mfu": [r.get("mfu") for r in steps],
           "flops_per_step": steps[0].get("flops_per_step"),
           "events": [e["event"] for e in events],
           "record_types": [r["type"] for r in recs],
           "jsonl_records": len(on_disk), "spans": sorted(spans),
           "launches_fwd_dq_dkv": counts, "tensors_differing": len(diff),
           "max_abs_diff": max(diff.values(), default=0.0),
           "max_rel_diff": rel, "nondeterministic_ops": det.ops,
           "run_s": run_s}
    print("observed lm " + json.dumps(out), flush=True)
    check([r["step"] for r in steps] == list(range(1, P17_STEPS + 1)),
          f"step records {[r['step'] for r in steps]}")
    check(len(on_disk) == len(recs), f"{len(on_disk)} JSONL lines for "
          f"{len(recs)} records")
    check(sum(r["nonfinite_steps"] for r in steps) == 1
          and steps[P17_POISON - 1]["nonfinite_steps"] == 1,
          f"non-finite steps {out['nonfinite_steps']}")
    check(all(math.isfinite(v) for i, v in enumerate(losses)
              if i + 1 != P17_POISON), f"losses {losses}")
    check(events and all(e["event"] == "nan_guard" and e["action"] == "skip"
                         for e in events if e["event"] == "nan_guard"),
          f"events {out['events']}")
    check(recs[0]["type"] == "run_start" and recs[-1]["type"] == "run_end",
          f"record types {out['record_types']}")
    check({"data fetch", "step dispatch", "loss sync", "validation",
           "optimize/distri"} <= spans, f"spans {sorted(spans)}")
    check(counts == (LM_LAYERS * P17_STEPS,) * 3,
          f"flash launches (fwd, dq, dkv) {counts} != {LM_LAYERS} x "
          f"{P17_STEPS} each")
    if rtol == 0:
        check(not diff, f"the skipped step changed {len(diff)} tensors "
              f"(largest {out['max_abs_diff']:.3e}): not a no-op")
    else:
        check(rel <= rtol, f"the skipped step's tensors differ by {rel:.2e} "
              f"> {rtol} (ops not deterministic: {det.ops})")
    return dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"), counts))


def observed_generation_phase(ak):
    """17(b): phase 4's configuration with and without telemetry, every
    request queued before the dispatcher starts (the same batching in
    both runs)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.observability import (InMemorySink, SpanTracer,
                                               Telemetry, validate_record)
    from bigdl_tpu_torch.serving import GenerationEngine
    cfg = dict(vocab_size=1024, embed_dim=512, n_layer=4, n_head=8)
    model = TransformerLM(**cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    n_new = 32
    lengths = [3, 9, 17, 40, 100, 250, 500, 900, 1300, 1900]
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg["vocab_size"] + 1, size=n).astype(np.int32)
               for n in lengths]
    sink = InMemorySink()
    tracer = SpanTracer(process_name="chip_smoke generation")
    runs = {}
    for name in ("plain", "telemetry"):
        kw = {} if name == "plain" else dict(
            telemetry=Telemetry(sink, flight=False), tracer=tracer,
            emit_every=8)
        with GenerationEngine(model, slots=8, max_len=2048, prefill_batch=4,
                              max_new_tokens=n_new, device="cuda",
                              start=False, **kw) as eng:
            streams = [eng.generate(p) for p in prompts]
            ak.flash_attention_forward.launches = 0
            t0 = time.perf_counter()
            eng.start()
            toks = [s.result(timeout=600) for s in streams]
            wall = time.perf_counter() - t0
            launches = ak.flash_attention_forward.launches
            stats = eng.generation_stats()
        runs[name] = {"tokens": toks, "wall_s": wall, "launches": launches,
                      "prefill_batches": stats["prefill_batches"]}
    traces = [r for r in sink.records if r["type"] == "trace"]
    for r in sink.records:
        validate_record(r)
    kinds = [r["type"] for r in sink.records]
    out = {"requests": len(prompts), "tokens": n_new,
           "wall_s": {k: v["wall_s"] for k, v in runs.items()},
           "launches": {k: v["launches"] for k, v in runs.items()},
           "prefill_batches": runs["telemetry"]["prefill_batches"],
           "trace_records": len(traces),
           "generation_records": kinds.count("generation"),
           "prefill_ms": [r.get("prefill_ms") for r in traces],
           "decode_ms": [r.get("decode_ms") for r in traces],
           "spans": len(tracer.events)}
    print("observed generation " + json.dumps(out), flush=True)
    check(runs["telemetry"]["tokens"] == runs["plain"]["tokens"],
          "the telemetered engine's greedy tokens differ from the plain "
          "engine's")
    check(len(traces) == len(prompts)
          and all(r["status"] == "ok" and r["tokens"] == n_new
                  and r["kind"] == "generate" for r in traces),
          f"{len(traces)} trace records for {len(prompts)} requests")
    check(sorted(r["prompt_tokens"] for r in traces) == lengths,
          "the trace records' prompt sizes differ from the requests'")
    for v in runs.values():
        check(v["launches"] == v["prefill_batches"] * cfg["n_layer"] > 0,
              f"flash launches {v['launches']} != prefill batches "
              f"{v['prefill_batches']} x {cfg['n_layer']} layers")
    check(kinds.count("generation") >= 1 and kinds[-1] == "serving_summary",
          f"record types {sorted(set(kinds))}")
    del model
    torch.cuda.empty_cache()


def observed_serving_phase(sk, bk, model):
    """17(c): phase 10(b)'s served ResNet-50 burst with telemetry and a
    tracer."""
    from bigdl_tpu_torch.observability import (InMemorySink, SpanTracer,
                                               Telemetry, validate_record)
    from bigdl_tpu_torch.serving import InferenceEngine
    images = np.random.RandomState(0).rand(
        SERVE_BURST, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    sink = InMemorySink()
    tracer = SpanTracer(process_name="chip_smoke serving")
    os.environ[STEM_ENV] = "1"
    try:
        with InferenceEngine(model, max_batch_size=SERVE_BATCH,
                             max_wait_ms=2.0,
                             telemetry=Telemetry(sink, flight=False),
                             tracer=tracer, emit_every=1,
                             device="cuda") as eng:
            _reset_stem_counts(sk, bk)
            eng.warmup(images[0])
            t0 = time.perf_counter()
            futs = [eng.submit(images[i]) for i in range(SERVE_BURST)]
            got = [f.result(300) for f in futs]
            wall = time.perf_counter() - t0
            launches = _stem_counts(sk, bk)
            stats = eng.stats()
            buckets = len(eng.buckets)
    finally:
        os.environ.pop(STEM_ENV, None)
    for r in sink.records:
        validate_record(r)
    traces = [r for r in sink.records if r["type"] == "trace"]
    kinds = [r["type"] for r in sink.records]
    out = {"requests": SERVE_BURST, "wall_s": wall,
           "requests_per_sec": SERVE_BURST / wall,
           "batches": stats["batches"], "trace_records": len(traces),
           "serving_stats_records": kinds.count("serving_stats"),
           "latency_ms_p50": stats.get("latency_ms_p50"),
           "trace_latency_ms_p50": float(np.median(
               [r["latency_ms"] for r in traces])) if traces else None,
           "forward_ms_p50": float(np.median(
               [r["forward_ms"] for r in traces])) if traces else None,
           "launches": {"stem_conv": launches[0],
                        "bn_relu_fwd": launches[1]},
           "spans": len(tracer.events)}
    print("observed serving " + json.dumps(out), flush=True)
    check(all(np.isfinite(g).all() and g.shape == (1000,) for g in got),
          "served rows not finite or not 1000 wide")
    check(len(traces) == SERVE_BURST
          and all(r["status"] == "ok" for r in traces),
          f"{len(traces)} trace records for {SERVE_BURST} requests")
    check(kinds.count("serving_stats") == stats["batches"]
          and kinds[-1] == "serving_summary",
          f"{kinds.count('serving_stats')} serving_stats records for "
          f"{stats['batches']} batches; last {kinds[-1]}")
    want = stats["batches"] + buckets
    check(launches == (want, want),
          f"launches (stem, BN+ReLU) {launches} != batches "
          f"{stats['batches']} + warm-up buckets {buckets} each")


def instrumentation_cost_phase(resnet):
    """17(d): ms a step with and without the instrumentation (telemetry
    with the grad norms, the tracer, the three monitors), in turns, at LM
    b8 T=2048 and ResNet-50 b128 (phases 8 and 6's recipes, the LM with
    phase 11(d)'s L2 clipping at 1.0, so that no turn trains on NaN
    weights; the weights put back before every turn). Printed, not
    gated."""
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    TimeDistributedCriterion)
    from bigdl_tpu_torch.observability import InMemorySink
    from bigdl_tpu_torch.tools import bench
    device = torch.device("cuda")
    lm = bench._lm(LM_CFG["vocab_size"], device,
                   torch.Generator().manual_seed(0))
    configs = {
        "lm": (lm, bench._token_batch(LM_CFG["vocab_size"], 2048, 8),
               lambda: TimeDistributedCriterion(ClassNLLCriterion()), 1.0),
        "resnet50": (resnet, bench._image_batch((224, 224, 3), 1000, 128),
                     ClassNLLCriterion, None)}
    out = {}
    for name, (model, batch, crit, clip) in configs.items():
        start = {k: v.clone() for k, v in model.state_dict().items()}
        turns = []
        for turn in range(2 * P17_TURNS):
            instrumented = turn % 2 == 1
            with torch.no_grad():
                for k, v in model.state_dict().items():
                    v.copy_(start[k])
            opt = bench._resident_optimizer(model, *batch, crit(), device)
            if clip is not None:
                opt.set_gradient_clipping_by_l2_norm(clip)
            sink = InMemorySink()
            if instrumented:
                _instrument(opt, sink, None, resources=True)
            window_s, losses = bench._timed_run(opt, **P17_COST)
            turns.append({"instrumented": instrumented,
                          "ms_per_step": 1e3 * window_s / P17_COST["sync"],
                          "records": len(sink.records),
                          "finite_losses": int(np.isfinite(losses).sum())})
            del opt
        plain = [t["ms_per_step"] for t in turns if not t["instrumented"]]
        inst = [t["ms_per_step"] for t in turns if t["instrumented"]]
        out[name] = {"turns": turns, "plain_ms": plain,
                     "instrumented_ms": inst,
                     "overhead_ms": float(np.mean(inst) - np.mean(plain)),
                     "overhead_rel": float(np.mean(inst) / np.mean(plain)
                                           - 1)}
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(start[k])
    out["recipe"] = {**P17_COST, "turns": 2 * P17_TURNS,
                     "precision": "bfloat16 compute, f32 masters",
                     "lm_clip": 1.0}
    print("instrumentation cost " + json.dumps(out), flush=True)
    del lm
    torch.cuda.empty_cache()
    return out


def observability_phase(ak, sk, bk):
    """17: the phase's four parts; returns 17(a)'s kernel launches."""
    from bigdl_tpu_torch.models import ResNet50
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = observed_lm_phase(ak, tmp)
    observed_generation_phase(ak)
    resnet = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    observed_serving_phase(sk, bk, resnet)
    instrumentation_cost_phase(resnet)
    del resnet
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- 18. elastic training and preemption ---------------------------------------

P18_SLOTS = 4
P18_STEPS = 12
P18_SYNC = 2
P18_LOSE_AT = 5      # mesh.device_loss hit that loses worker3
P18_REJOIN_AT = 8    # the step whose hook restores worker3
P18_COLLECTIVE_AT = 10  # mesh.collective hit that fails
P18_LM_STEPS = 6
P18_PREEMPT_AT = 3
#: the events 18(a) wants, in this causal order
P18_ORDER = ("fault_injected", "worker_lost", "elastic_shrink",
             "elastic_replay", "elastic_grow", "elastic_rebuild")


def _p18_batches():
    """18(a)'s data: 4 distinct b128 batches of 224x224x3 images and
    1-based labels (RandomState(0)), on the card, fed in order."""
    from bigdl_tpu_torch.dataset import MiniBatch
    rs = np.random.RandomState(0)
    out = []
    for _ in range(4):
        x = rs.rand(128, 224, 224, 3).astype(np.float32)
        y = (rs.randint(0, 1000, 128) + 1).astype(np.int32)
        out.append(MiniBatch(torch.from_numpy(x).cuda(),
                             torch.from_numpy(y).cuda()))
    return out


def _p18_resnet_run(batches, chaos):
    """18(a)'s run: ResNet-50 (phase 6's model, weights from seed 0) at
    global b128, bf16 compute with f32 masters, SGD momentum 0.9, elastic
    over 4 logical replicas on `SimulatedCluster(4)` over four slots of
    the card, bucketing on, sync every 2, 12 steps. With `chaos`, worker3
    is lost at `mesh.device_loss` hit 5, restored by the hook at step 8,
    and `mesh.collective` fails at hit 10. Returns the optimizer, the
    telemetry records, the loss of each step (a replayed step's last), the
    final state (host copies of the parameters, buffers and momentum),
    the kernels 6-7 launches and the wall seconds."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.parallel import build_mesh
    from bigdl_tpu_torch.resilience import (CollectiveError, DeviceLossError,
                                            FaultInjector, FaultSpec,
                                            SimulatedCluster)
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    slots = [torch.device("cuda", 0)] * P18_SLOTS
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    cluster = SimulatedCluster(P18_SLOTS, devices=slots, telemetry=tel)
    model = p11_model("cuda")
    opt = DistriOptimizer(model, _Resident(batches), ClassNLLCriterion(),
                          build_mesh(data=P18_SLOTS, devices=slots))
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_end_when(max_iteration(P18_STEPS))
    opt.set_sync_interval(P18_SYNC)
    opt.set_elastic(P18_SLOTS, registry=cluster.registry)
    opt.set_gradient_bucketing()
    opt.set_telemetry(tel)
    losses, velocity = {}, {}

    def hook(s):
        losses[s["neval"]] = s["loss"]
        if chaos and s["neval"] == P18_REJOIN_AT:
            cluster.restore(f"worker{P18_SLOTS - 1}")
        if s["neval"] == P18_STEPS:
            velocity.update({k: v.detach().cpu().clone() for k, v in
                             opt.opt_state["velocity"].items()})

    opt.set_iteration_hook(hook)
    plan = FaultInjector(
        FaultSpec("mesh.device_loss", at_hit=P18_LOSE_AT,
                  exc=lambda ctx: DeviceLossError(
                      "preempted", lost=(f"worker{P18_SLOTS - 1}",))),
        FaultSpec("mesh.collective", at_hit=P18_COLLECTIVE_AT,
                  exc=CollectiveError), telemetry=tel)
    _reset_bn_counts(bk)
    t0 = time.perf_counter()
    if chaos:
        with plan:
            opt.optimize()
    else:
        opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    state.update({f"velocity/{k}": v for k, v in velocity.items()})
    return opt, sink.records, losses, state, launches, wall


def _p18_diff(got, want):
    """(the tensors that differ, the largest difference relative to each
    tensor's largest element)."""
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    rel = max((float((got[k].float() - want[k].float()).abs().max())
               / max(float(want[k].float().abs().max()), 1e-30))
              for k in want)
    return diff, rel


def elastic_resnet_phase():
    """18(a). Returns the chaos run's launches of kernels 6 and 7."""
    batches = _p18_batches()
    with Deterministic() as det:
        opt_o, recs_o, losses_o, want, _, oracle_s = _p18_resnet_run(
            batches, False)
        del opt_o
        torch.cuda.empty_cache()
        opt, recs, losses, got, launches, chaos_s = _p18_resnet_run(
            batches, True)
    stats = dict(opt.elastic_stats)
    del opt
    torch.cuda.empty_cache()
    events = [r for r in recs if r["type"] == "event"]
    kinds = [e["event"] for e in events]
    t_lost = next(r["time"] for r in recs if r.get("event") == "worker_lost")
    after = [r for r in recs if r["type"] == "step" and r["time"] > t_lost]
    mttr = after[0]["time"] - t_lost if after else None
    shrink = next((e for e in events if e["event"] == "elastic_shrink"), {})
    grow = next((e for e in events if e["event"] == "elastic_grow"), {})
    rebuild = next((e for e in events if e["event"] == "elastic_rebuild"),
                   {})
    diff, rel = _p18_diff(got, want)
    rtol = NONDET_RTOL if det.ops else 0.0
    dispatches = stats["shard_dispatches"]
    # ms a step over each sync window (the commits and the tail left out)
    step_ms = [[1e3 * r["step_time_s"] for r in rs if r["type"] == "step"]
               for rs in (recs, recs_o)]
    # the synced losses (every second step; the others repeat the last)
    synced = [losses.get(k) for k in range(P18_SYNC, P18_STEPS + 1,
                                            P18_SYNC)]
    synced_o = [losses_o.get(k) for k in range(P18_SYNC, P18_STEPS + 1,
                                               P18_SYNC)]
    out = {"model": "ResNet50 s2d (cuDNN stem)", "global_batch": 128,
           "logical_replicas": P18_SLOTS, "slots": P18_SLOTS,
           "precision": "bfloat16 compute, f32 masters", "sync": P18_SYNC,
           "steps": P18_STEPS, "bucketing": True, "synced_losses": synced,
           "oracle_synced_losses": synced_o, "events": kinds,
           "shrink": {k: shrink.get(k) for k in (
               "step", "n_active_before", "n_active", "degraded_capacity")},
           "grow": {k: grow.get(k) for k in (
               "step", "n_active_before", "n_active", "degraded_capacity")},
           "rebuild_step": rebuild.get("step"), "mttr_s": mttr,
           "replayed_batches": stats["replayed_batches"],
           "recoveries": stats["recoveries"],
           "shard_dispatches": dispatches,
           "shard_dispatches_per_step": dispatches / P18_STEPS,
           "commits": stats["commits"],
           "commit_ms": 1e3 * stats["commit_s"] / max(stats["commits"], 1),
           "launches_fwd_bwd": launches,
           "tensors_compared": len(want), "tensors_differing": len(diff),
           "max_rel_diff": rel, "nondeterministic_ops": det.ops,
           "step_ms": step_ms[0], "oracle_step_ms": step_ms[1],
           "oracle_s": oracle_s, "chaos_s": chaos_s}
    print("elastic resnet " + json.dumps(out), flush=True)
    check(sorted(losses) == list(range(1, P18_STEPS + 1))
          and all(v is not None and math.isfinite(v) for v in synced),
          f"the run did not reach step {P18_STEPS} with finite losses: "
          f"{synced}")
    check(all(k in kinds for k in P18_ORDER), f"events {kinds}")
    order = [kinds.index(k) for k in P18_ORDER]
    check(order == sorted(order), f"events out of causal order: {kinds}")
    check((shrink.get("n_active_before"), shrink.get("n_active"),
           shrink.get("degraded_capacity")) == (4, 3, 0.25),
          f"shrink {out['shrink']}")
    check((grow.get("n_active_before"), grow.get("n_active")) == (3, 4),
          f"grow {out['grow']}")
    check(stats["replayed_batches"] >= 1 and mttr is not None,
          f"replayed {stats['replayed_batches']}, MTTR {mttr}")
    if rtol == 0:
        check(synced == synced_o and not diff,
              f"losses {synced} vs the uninterrupted {synced_o}; "
              f"{len(diff)} tensors differ (largest {rel:.2e}): not bit "
              "for bit")
    else:
        check(_same(synced, synced_o, rtol) and rel <= rtol,
              f"losses {synced} vs {synced_o}, tensors {rel:.2e} > {rtol} "
              f"(ops not deterministic: {det.ops})")
    check(launches == (BN_SITES * dispatches,) * 2,
          f"BN+ReLU launches {launches} != {BN_SITES} x {dispatches} shard "
          "dispatches each")
    return dict(zip(("bn_relu_fwd", "bn_relu_bwd"), launches))


def _p18_lm_run(x, y, ckpt, preempt, resume=False):
    """18(b)'s run: phase 8's LM recipe (b8, T=2048, bf16 compute with f32
    masters, SGD momentum 0.9) clipped at 1.0, through `DistriOptimizer`
    to step 6 with a checkpoint directory and, with `preempt`, a
    preemption handler and SIGTERM from the hook at step 3. Returns the
    optimizer, its records, the losses by step and the parameters."""
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, max_iteration,
                                       several_iteration)
    import signal
    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    opt = DistriOptimizer(model, _Resident([MiniBatch(x, y)]),
                          TimeDistributedCriterion(ClassNLLCriterion()),
                          devices=["cuda"])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(max_iteration(P18_LM_STEPS))
    opt.set_checkpoint(ckpt, several_iteration(1000))
    sink = InMemorySink()
    opt.set_telemetry(Telemetry(sink, resources=False, flight=False))
    if resume:
        check(opt.resume_from_latest_checkpoint(),
              f"nothing to resume from under {ckpt}")
    losses = {}

    def hook(s):
        losses[s["neval"]] = s["loss"]
        if preempt and s["neval"] == P18_PREEMPT_AT:
            signal.raise_signal(signal.SIGTERM)

    opt.set_iteration_hook(hook)
    if preempt:
        opt.set_preemption_handler(grace_s=30.0)
    opt.optimize()
    params = {k: p.detach().cpu().clone()
              for k, p in model.named_parameters()}
    return opt, sink.records, losses, params


def preemption_lm_phase(ak, tmp):
    """18(b). Returns the preempted and resumed runs' launches of kernels
    1, 3 and 4."""
    import signal
    from bigdl_tpu_torch.tools.bench import _token_batch
    x, y = _token_batch(LM_CFG["vocab_size"], 2048, 8)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    prior = signal.getsignal(signal.SIGTERM)
    with Deterministic() as det:
        _, _, losses_o, want = _p18_lm_run(x, y, os.path.join(tmp, "o"),
                                           False)
        torch.cuda.empty_cache()
        _reset_flash_counts(ak)
        t0 = time.perf_counter()
        opt, recs, losses_p, _ = _p18_lm_run(x, y, os.path.join(tmp, "p"),
                                             True)
        stop_s = time.perf_counter() - t0
        stopped = opt.optim_method.state["neval"]
        preempted_counts = _flash_counts(ak)
        del opt
        torch.cuda.empty_cache()
        _reset_flash_counts(ak)
        opt, _, losses_r, got = _p18_lm_run(x, y, os.path.join(tmp, "p"),
                                            False, resume=True)
        resumed_counts = _flash_counts(ak)
        del opt
    torch.cuda.empty_cache()
    restored = signal.getsignal(signal.SIGTERM) == prior
    kinds = [r.get("event", r["type"]) for r in recs]
    pre = [r for r in recs if r.get("event") == "preempted"]
    diff, rel = _p18_diff(got, want)
    rtol = NONDET_RTOL if det.ops else 0.0
    tail = [losses_o[k] for k in sorted(losses_o) if k > P18_PREEMPT_AT]
    rest = [losses_r[k] for k in sorted(losses_r)]
    out = {"batch": 8, "seq": 2048, "steps": P18_LM_STEPS,
           "sigterm_at": P18_PREEMPT_AT, "stopped_at": stopped,
           "records": kinds, "preempted": pre,
           "disposition_restored": restored,
           "losses_uninterrupted": [losses_o[k] for k in sorted(losses_o)],
           "losses_preempted": [losses_p[k] for k in sorted(losses_p)],
           "losses_resumed": rest, "tensors_differing": len(diff),
           "max_rel_diff": rel, "nondeterministic_ops": det.ops,
           "launches_fwd_dq_dkv_preempted": preempted_counts,
           "launches_fwd_dq_dkv_resumed": resumed_counts,
           "preempted_run_s": stop_s}
    print("preemption lm " + json.dumps(out), flush=True)
    check(stopped == P18_PREEMPT_AT, f"stopped at step {stopped}")
    check(len(pre) == 1 and pre[0]["checkpointed"] is True
          and kinds[-2:] == ["preempted", "run_abort"]
          and "run_end" not in kinds, f"records {kinds}")
    check(restored, "the SIGTERM disposition was not restored")
    if rtol == 0:
        check(rest == tail and not diff,
              f"resumed losses {rest} vs {tail}, {len(diff)} tensors "
              "differ: not bit for bit")
    else:
        check(_same(rest, tail, rtol) and rel <= rtol,
              f"resumed losses {rest} vs {tail}, params {rel:.2e} > {rtol} "
              f"(ops not deterministic: {det.ops})")
    for counts in (preempted_counts, resumed_counts):
        check(counts == (LM_LAYERS * P18_PREEMPT_AT,) * 3,
              f"flash launches (fwd, dq, dkv) {counts} != {LM_LAYERS} x "
              f"{P18_PREEMPT_AT} each")
    return dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"),
                    [a + b for a, b in zip(preempted_counts,
                                           resumed_counts)]))


def drill_phase():
    """18(c): `tools/bench.py --device-loss` on the card."""
    from bigdl_tpu_torch.tools.bench import bench_chaos_device_loss
    out = bench_chaos_device_loss(device="cuda")
    print("device loss drill " + json.dumps(out), flush=True)
    check(out["recovered"] and out["grew_back"]
          and out["replayed_batches"] >= 1, f"drill {out}")


def sp_repair_phase(ak):
    """18(d): `tools/transformer_lm.py --sequence-parallel ring` and
    `zigzag` at `--long-len 2048` on the repeated card."""
    from bigdl_tpu_torch.tools import transformer_lm
    n = len(sp_mesh_devices())
    want = {"ring": n * n, "zigzag": n * (2 * n + 1)}
    out = {}
    for scheme in ("ring", "zigzag"):
        ak.flash_attention_carry.launches = 0
        ppl = transformer_lm.main(["--sequence-parallel", scheme,
                                   "--long-len", "2048"])
        out[scheme] = {"ppl": ppl,
                       "carry_launches": ak.flash_attention_carry.launches}
    print("sequence parallel repair " + json.dumps(out), flush=True)
    for scheme, w in want.items():
        check(out[scheme]["carry_launches"] == w,
              f"{scheme}: kernel 2 launched "
              f"{out[scheme]['carry_launches']} times, not {w}")


def elastic_phase(ak):
    """18: the phase's five parts; returns 18(a)'s launches of kernels 6
    and 7 and 18(b)'s of kernels 1, 3 and 4."""
    t0 = time.perf_counter()
    bn = elastic_resnet_phase()
    with tempfile.TemporaryDirectory() as tmp:
        lm = preemption_lm_phase(ak, tmp)
    drill_phase()
    sp_repair_phase(ak)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    return bn, lm


# ---------------------------------------------------------------- phase 19
# int8 post-training quantization. Full int8 against the same module on the
# CPU: the weights, scales and int32 sums are the same integers, and the
# epilogue the same f32 arithmetic, so an f32 x gives the same bits; a bf16
# x within P19_BF16_RTOL (reported bitwise or not). Weight-only against its
# float module: the reference's bound (tests/test_quantized.py:168-174).
P19_BF16_RTOL = 1e-6
P19_WEIGHT_ONLY_RTOL = 0.03
# served weight-only rows against LocalPredictor's: cuDNN / cuBLAS in f32
# at other batch shapes
P19_SERVE_WO_RTOL = 1e-2
# ResNet-50 (plain stem): 53 convolutions + the classifier; the served s2d
# stem stays float (Quantizer converts exact SpatialConvolutions only)
P19_PRODUCTS = 54
P19_SERVED_PRODUCTS = 53


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def quant_layer_phase():
    """19(a): each full-int8 layer on the card against the same module's
    forward on the CPU, and the weight-only twin against its float layer;
    each layer's device ms beside the bf16 float layer's."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.quantized import Quantizer
    conv = functools.partial(nn.SpatialConvolution, with_bias=False,
                             device="cuda")
    cases = [
        ("linear 2048->1000 M=1", lambda g: nn.Linear(
            2048, 1000, device="cuda", generator=g), (1, 2048)),
        ("linear 2048->1000 M=17", lambda g: nn.Linear(
            2048, 1000, device="cuda", generator=g), (17, 2048)),
        ("linear 2048->1000 M=256", lambda g: nn.Linear(
            2048, 1000, device="cuda", generator=g), (256, 2048)),
        ("stem 7x7/s2 K=147", lambda g: conv(3, 64, 7, 7, 2, 2, 3, 3,
                                             generator=g), (8, 224, 224, 3)),
        ("3x3 C=64", lambda g: conv(64, 64, 3, 3, 1, 1, 1, 1, generator=g),
         (8, 56, 56, 64)),
        ("1x1/s2 shortcut", lambda g: conv(256, 512, 1, 1, 2, 2, 0, 0,
                                           generator=g), (8, 56, 56, 256)),
        ("3x3 g=2 d=2 SAME", lambda g: nn.SpatialDilatedConvolution(
            64, 64, 3, 3, 1, 1, -1, -1, 2, 2, n_group=2, device="cuda",
            generator=g), (8, 28, 28, 64)),
    ]
    rows = []
    for i, (label, make, shape) in enumerate(cases):
        f = make(torch.Generator().manual_seed(i)).eval()
        q = Quantizer.quantize(f)
        qc = Quantizer.quantize(copy.deepcopy(f).to("cpu"))
        wo = Quantizer.quantize(f, weight_only=True)
        check(torch.equal(q.weight.cpu(), qc.weight)
              and torch.equal(q.scale.cpu(), qc.scale),
              f"{label}: int8 weights or scales differ from the CPU's")
        x = torch.from_numpy(np.random.RandomState(i).randn(*shape).astype(
            np.float32))
        row = {"layer": label, "x": list(shape)}
        with torch.inference_mode():
            for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                xc = x.to(dt)
                xg = xc.cuda()
                acc, xs = q.accumulate(xg)
                acc_c, xs_c = qc.accumulate(xc)
                check(torch.equal(acc.cpu(), acc_c)
                      and torch.equal(xs.cpu(), xs_c),
                      f"{label} {tag}: int32 sums or scales differ")
                y, yc = q(xg).cpu(), qc(xc)
                bitwise = torch.equal(y, yc)
                row[f"{tag}_bitwise"] = bitwise
                row[f"{tag}_rel_err"] = _rel(y, yc)
                check(bitwise if tag == "f32"
                      else row["bf16_rel_err"] <= P19_BF16_RTOL,
                      f"{label} {tag}: the card's output is off the CPU's "
                      f"({row[f'{tag}_rel_err']:.3e})")
            xg = x.cuda()
            row["weight_only_rel_err"] = _rel(wo(xg), f(xg))
            check(row["weight_only_rel_err"] <= P19_WEIGHT_ONLY_RTOL,
                  f"{label}: weight-only off its float layer "
                  f"({row['weight_only_rel_err']:.3e})")
            xb = xg.bfloat16()
            fb = copy.deepcopy(f).to(torch.bfloat16)
            wb = copy.deepcopy(wo).to(torch.bfloat16)
            row["ms"] = {"full_int8": cuda_ms(lambda: q(xb), 10),
                         "weight_only": cuda_ms(lambda: wb(xb), 10),
                         "bf16": cuda_ms(lambda: fb(xb), 10)}
        rows.append(row)
        print("int8 layer " + json.dumps(row), flush=True)
    return rows


def quant_bench_phase(bk):
    """19(b): `tools/bench.py --model int8_serving` (ResNet-50 b256);
    returns its kernel 6 launches."""
    from bigdl_tpu_torch.tools.bench import bench_int8_serving
    out = bench_int8_serving()
    print("int8 serving bench " + json.dumps(out), flush=True)
    v = out["variants"]
    for name, row in v.items():
        check(row["bn_relu_fwd_per_forward"] == BN_SITES,
              f"{name}: kernel 6 launched {row['bn_relu_fwd_per_forward']} "
              f"times a forward, not {BN_SITES}")
        check(row["images_per_s"] > 0, f"{name}: {row['images_per_s']}")
    check(v["full int8"]["int8_mm_per_forward"] == P19_PRODUCTS
          and v["full int8"]["float_product_per_forward"] == 0,
          f"full int8: {v['full int8']}")
    check(v["weight-only int8"]["float_product_per_forward"] == P19_PRODUCTS
          and v["weight-only int8"]["int8_mm_per_forward"] == 0,
          f"weight-only int8: {v['weight-only int8']}")
    for name in ("weight-only int8", "full int8"):
        check(math.isfinite(v[name]["max_abs_diff_vs_bf16"]),
              f"{name}: outputs not finite")
    return sum(round(r["bn_relu_fwd_per_forward"] * out["iters"])
               for r in v.values())


def quant_serving_phase(sk, bk):
    """19(c): `ResNet(1000, depth=50, s2d_stem=True)` (f32, randomized BN
    state, the stem switch set) quantized both ways, a burst of 96 through
    `InferenceEngine(convert=False)` against `LocalPredictor(convert=
    False)`. Returns kernels 5 and 6's launches."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn.quantized import Quantizer, float_product, int8_mm
    from bigdl_tpu_torch.optim import LocalPredictor
    from bigdl_tpu_torch.serving import InferenceEngine
    model = ResNet(class_num=1000, depth=50, s2d_stem=True, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    _randomize_bn_state(model, 2)
    images = np.random.RandomState(0).rand(
        SERVE_BURST, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    launches = {"stem_conv": 0, "bn_relu_fwd": 0}
    os.environ[STEM_ENV] = "1"
    try:
        for weight_only in (False, True):
            label = "weight-only int8" if weight_only else "full int8"
            q = Quantizer.quantize(model, weight_only=weight_only)
            ref = np.stack(LocalPredictor(q, batch_size=SERVE_BATCH,
                                          convert=False,
                                          device="cuda").predict(images))
            products = float_product if weight_only else int8_mm
            with InferenceEngine(q, max_batch_size=SERVE_BATCH,
                                 max_wait_ms=2.0, convert=False,
                                 device="cuda") as eng:
                eng.warmup(images[0])
                _reset_stem_counts(sk, bk)
                products.launches = 0
                t0 = time.perf_counter()
                futs = [eng.submit(img) for img in images]
                got = np.stack([f.result(300) for f in futs])
                wall = time.perf_counter() - t0
                counts = _stem_counts(sk, bk)
                stats = eng.stats()
            diff = np.abs(got - ref)
            rel = float(diff.max() / np.abs(ref).max())
            out = {"model": label, "requests": SERVE_BURST, "wall_s": wall,
                   "requests_per_sec": SERVE_BURST / wall,
                   **{k: stats.get(k) for k in (
                       "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
                       "batch_size_p50", "batches", "completed", "failed")},
                   "bitwise": bool((diff == 0).all()), "rel_err": rel,
                   "launches": {"stem_conv": counts[0],
                                "bn_relu_fwd": counts[1],
                                "products": products.launches},
                   "argmax_agreement": float(
                       (got.argmax(1) == ref.argmax(1)).mean())}
            print("int8 serving " + json.dumps(out), flush=True)
            b = stats["batches"]
            check(stats["completed"] == SERVE_BURST and np.isfinite(got).all(),
                  f"{label}: {stats['completed']} of {SERVE_BURST} served")
            check(counts == (b, BN_SITES * b)
                  and products.launches == P19_SERVED_PRODUCTS * b,
                  f"{label}: launches {out['launches']} for {b} batches")
            check(rel <= (P19_SERVE_WO_RTOL if weight_only else 0.0),
                  f"{label}: served rows off offline predict ({rel:.3e})")
            launches["stem_conv"] += counts[0]
            launches["bn_relu_fwd"] += counts[1]
    finally:
        os.environ.pop(STEM_ENV, None)
    del model, q
    torch.cuda.empty_cache()
    return launches


def quantization_phase(sk, bk):
    """19: (a)-(c) and the phase's wall time; returns the launches of
    kernels 5 and 6 in (b) and (c)."""
    t0 = time.perf_counter()
    quant_layer_phase()
    bench_bn = quant_bench_phase(bk)
    served = quant_serving_phase(sk, bk)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"stem_conv": served["stem_conv"],
            "bn_relu_fwd": bench_bn + served["bn_relu_fwd"]}


# phase 20: the serving fleet. (a) the reference's drill over the served
# ResNet-50 (replicas, closed-loop clients x requests, engine batch);
# (b) the breaker's failure threshold; (c) the generation fleet's
# replicas, sessions and tokens a stream, and the tokens a stream
# delivers before its replica is failed
FLEET_REPLICAS = 3
FLEET_CLIENTS, FLEET_PER_CLIENT = 6, 40
FLEET_BATCH = 8
FLEET_IMAGES = 32
P20_THRESHOLD = 2
GEN_FLEET_REPLICAS = 2
GEN_FLEET_SESSIONS = 8
GEN_FLEET_NEW = 32
GEN_FLEET_FAIL_AT = 3


def _fleet_images():
    return np.random.RandomState(0).rand(
        FLEET_IMAGES, SERVE_HW, SERVE_HW, 3).astype(np.float32)


def _fleet_model_and_ref(images):
    """Phase 10(b)'s served ResNet-50 (f32, seed 0) and the cuDNN-stem
    twin's rows for `images`."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.optim import LocalPredictor
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    os.environ.pop(STEM_ENV, None)
    twin = LocalPredictor(model, batch_size=FLEET_BATCH, device="cuda")
    twin.model.get_submodule("0_conv1").pallas_stem = False
    return model, np.stack(twin.predict(images))


def fleet_resnet_phase(sk, bk, model, images, ref):
    """20(a): `tools/bench.py`'s serve_fleet drill with --crash over
    ResNet-50 at 224x224 (f32, the stem switch set), 3 replicas sharing
    the card; then replica1 restored. Returns kernels 5 and 6's launches,
    warm-ups included."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.observability import InMemorySink, Telemetry
    from bigdl_tpu_torch.serving import InferenceEngine, ServingFleet
    from bigdl_tpu_torch.tools.bench import serve_fleet_drill
    samples = [Sample(x) for x in images]
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    engines = []  # every engine the fleet builds, the killed one included

    def factory(rid):
        eng = InferenceEngine(model, max_batch_size=FLEET_BATCH,
                              max_wait_ms=1.0, queue_capacity=256,
                              admission="reject", telemetry=tel,
                              replica_id=rid, device="cuda")
        engines.append(eng)
        return eng

    _reset_stem_counts(sk, bk)
    fleet = ServingFleet(engine_factory=factory, n_replicas=FLEET_REPLICAS,
                         warmup_sample=samples[0], telemetry=tel,
                         drain_grace_s=0.5, lease_s=30.0)
    try:
        out, rows = serve_fleet_drill(fleet, samples, sink, FLEET_CLIENTS,
                                      FLEET_PER_CLIENT, crash=True)
        restored = fleet.restore("replica1")
        warmups = fleet._replicas["replica1"].warmups
        health = fleet.health()
    finally:
        fleet.close()
        tel.close()
    launches = _stem_counts(sk, bk)
    stats = [e.stats() for e in engines]
    want = sum(st["batches"] + len(e.buckets)
               for e, st in zip(engines, stats))
    total = FLEET_CLIENTS * FLEET_PER_CLIENT
    idx = [i for i, _ in rows]
    share, clear = _check_rows(np.stack([r for _, r in rows]), ref[idx],
                               "fleet")
    out.update({"engines_built": len(engines),
                "batches": [st["batches"] for st in stats],
                "warmup_buckets": [len(e.buckets) for e in engines],
                "launches": {"stem_conv": launches[0],
                             "bn_relu_fwd": launches[1]},
                "restored_warmups": warmups,
                "max_share_of_limit": share, "argmax_rows_checked": clear,
                "flops_per_batch": stats[0]["flops_per_step"],
                "mfu": [st["mfu"] for st in stats]})
    print("fleet serving " + json.dumps(out), flush=True)
    check(out["ok"] + out["timed_out"] + out["rerouted"] == total
          and out["other"] == 0 and len(rows) == out["ok"],
          f"fleet: outcomes {out} do not add up to {total} requests")
    check(out["drains"] == 1 and out["mttr_s"] is not None
          and out["recovered"],
          f"fleet: drains {out['drains']}, MTTR {out['mttr_s']}")
    check(launches == (want, want),
          f"fleet: launches (stem, BN+ReLU) {launches} != batches + "
          f"warm-up buckets {want} over {len(engines)} engines")
    check(restored and warmups == 2 and len(engines) == FLEET_REPLICAS + 1
          and health["replicas"]["replica1"]["state"] == "active",
          f"fleet: restore {restored}, warm-ups {warmups}, engines "
          f"{len(engines)}")
    return launches


def breaker_phase(sk, bk, model, images, ref):
    """20(b): one engine with a breaker and a `serve.forward` plan on
    bucket 8: the bucket trips and sheds with kernel 5 unmoved, bucket 2
    serves throughout, one probe closes it after the reset timeout."""
    from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec
    from bigdl_tpu_torch.serving import (InferenceEngine, ServingError,
                                         ServingUnavailableError)
    clock = [0.0]
    label = f"b{FLEET_BATCH}[{SERVE_HW}x{SERVE_HW}x3:float32]"

    def burst(eng, n=FLEET_BATCH):
        futs = [eng.submit(images[i]) for i in range(n)]
        out = []
        for f in futs:
            try:
                out.append(f.result(300))
            except Exception as e:  # the caller checks the kinds
                out.append(e)
        return out

    def single(eng):
        return eng.predict(images[0], timeout=300)

    plan = FaultInjector(FaultSpec(
        "serve.forward", times=None, exc=RuntimeError,
        when=lambda ctx: ctx["bucket"] == FLEET_BATCH))
    with InferenceEngine(model, max_batch_size=FLEET_BATCH,
                         max_wait_ms=200.0, device="cuda",
                         breaker={"failure_threshold": P20_THRESHOLD,
                                  "reset_timeout_s": 60.0,
                                  "clock": lambda: clock[0]}) as eng:
        eng.warmup(images[0])
        served = [single(eng)]
        with plan:
            for _ in range(P20_THRESHOLD):
                got = burst(eng)
                check(all(isinstance(g, ServingError) for g in got),
                      "breaker: a poisoned batch did not fail")
            health = eng.health()
            k5 = _stem_counts(sk, bk)
            shed = burst(eng)
            k5_after = _stem_counts(sk, bk)
            served.append(single(eng))
            stats = eng.stats()
        clock[0] = 61.0
        probe = burst(eng)
        closed = eng.health()
        served.append(single(eng))
    out = {"open_buckets": health["open_buckets"],
           "status": health["status"], "shed": stats["shed"],
           "launches_while_shedding": [k5, k5_after],
           "probe_ok": sum(isinstance(g, np.ndarray) for g in probe),
           "after_probe": closed["status"],
           "plan_hits": plan.hits("serve.forward")}
    print("fleet breaker " + json.dumps(out), flush=True)
    check(health["status"] == "degraded" and health["open_buckets"] == [label],
          f"breaker: health {health}")
    check(all(isinstance(g, ServingUnavailableError) for g in shed)
          and stats["shed"] == FLEET_BATCH,
          f"breaker: the open bucket did not shed ({stats['shed']})")
    check(k5_after == k5, f"breaker: kernels 5-6 moved while shedding "
          f"({k5} -> {k5_after})")
    check(out["probe_ok"] == FLEET_BATCH and closed["status"] == "ok",
          f"breaker: the probe did not close the bucket ({out})")
    _check_rows(np.stack(served), np.stack([ref[0]] * len(served)),
                "breaker bucket 2")


def gen_fleet_phase(ak):
    """20(c): 2 `GenerationEngine` replicas over phase 1's LM behind a
    `ServingFleet`, 8 sessions of 32 tokens; the replica of session 0 is
    failed once it delivered 3 tokens. Returns kernel 1's launches."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (GenerationEngine, ServingFleet,
                                         greedy_decode_reference)
    cfg = dict(vocab_size=1024, embed_dim=512, n_layer=LM_LAYERS, n_head=8)
    model = TransformerLM(**cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    twin = TransformerLM(**cfg, use_flash=False, device="cuda")
    twin.load_state_dict(model.state_dict())
    lengths = [3, 9, 17, 40, 100, 250, 500, 900]
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg["vocab_size"] + 1, size=n).astype(np.int32)
               for n in lengths]
    engines = []

    def factory(rid):
        eng = GenerationEngine(model, slots=8, max_len=2048,
                               prefill_batch=4, max_new_tokens=GEN_FLEET_NEW,
                               replica_id=rid, device="cuda")
        engines.append(eng)
        return eng

    ak.flash_attention_forward.launches = 0
    fleet = ServingFleet(engine_factory=factory,
                         n_replicas=GEN_FLEET_REPLICAS,
                         warmup_sample=prompts[0], drain_grace_s=0.0)
    results = [None] * len(prompts)
    delivered = threading.Event()
    try:
        streams = [fleet.generate(p, session=f"gen{i}")
                   for i, p in enumerate(prompts)]
        victim = streams[0].replica_id

        def consume(i):
            toks = []
            try:
                for tok in streams[i]:
                    toks.append(tok)
                    if i == 0 and len(toks) == GEN_FLEET_FAIL_AT:
                        delivered.set()
            except Exception as e:  # reported below with the count
                print(f"stream {i}: {e!r}", file=sys.stderr)
            results[i] = toks

        # daemon consumers: a stream that hangs fails the check below
        # without holding the process open
        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        check(delivered.wait(300), "gen fleet: session 0 never delivered")
        fleet.fail(victim)
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counters = fleet.fleet_counters()
        reroutes = [s.reroutes for s in streams]
        moved = [s.replica_id for s in streams]
    finally:
        fleet.close()
    launches = ak.flash_attention_forward.launches
    gstats = [e.generation_stats() for e in engines]
    warm = len(engines[0].seq_buckets) * len(engines[0].buckets)
    prefills = sum(g["prefill_batches"] + warm for g in gstats)
    out = {"victim": victim, "reroutes": reroutes, "replicas": moved,
           "stream_reroutes_total": counters["stream_reroutes_total"],
           "tokens": [len(r or []) for r in results], "wall_s": wall,
           "prefill_batches": [g["prefill_batches"] for g in gstats],
           "warmup_prefills": warm, "kernel_launches": launches}
    print("fleet generation " + json.dumps(out), flush=True)
    check(all(r is not None and len(r) == GEN_FLEET_NEW for r in results),
          f"gen fleet: tokens {out['tokens']}")
    check(counters["stream_reroutes_total"] >= 1 and reroutes[0] == 1,
          f"gen fleet: reroutes {reroutes}")
    check(launches == prefills * LM_LAYERS,
          f"gen fleet: kernel 1 launched {launches}, not {prefills} "
          f"prefill batches x {LM_LAYERS} layers")
    for i, n in enumerate(reroutes):
        if n:
            k = check_tokens(model, twin, prompts[i], results[i],
                             greedy_decode_reference)
            print(f"gen fleet: spliced stream {i} (prompt {lengths[i]}): "
                  f"{k}/{GEN_FLEET_NEW} tokens equal the reference",
                  flush=True)
    del model, twin
    torch.cuda.empty_cache()
    return launches


def fleet_phase(ak, sk, bk):
    """20: (a)-(c) and the phase's wall time; returns the launches of
    kernels 1, 5 and 6."""
    t0 = time.perf_counter()
    images = _fleet_images()
    model, ref = _fleet_model_and_ref(images)
    os.environ[STEM_ENV] = "1"
    try:
        stem, bn = fleet_resnet_phase(sk, bk, model, images, ref)
        breaker_phase(sk, bk, model, images, ref)
    finally:
        os.environ.pop(STEM_ENV, None)
    del model
    torch.cuda.empty_cache()
    flash = gen_fleet_phase(ak)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"flash_attention_fwd": flash, "stem_conv": stem,
            "bn_relu_fwd": bn}


# 21: pipeline and expert parallelism, DistriPredictor
# (a) ResNet-50 through 1F1B: b64 in 8 microbatches over a "pipe" mesh of 4
# positions, 4 SGD steps; the microbatch oracle runs the same function as
# one plain loop, so loss and gradients agree to f32 summation order: the
# loss within PIPE_LOSS_RTOL relative, each gradient within PIPE_GRAD_TOL
# of its tensor's largest element. cuDNN's f32 backward sums with atomics,
# so the two 4-step runs drift apart as any two runs do, fastest in a
# tensor of small values (a BN shift that starts at 0 drifts ~1e-2 of its
# largest element in 4 steps on an H100); the parameters after 4 steps
# are held as the update, PIPE_UPDATE_RTOL of its norm over all parameters
PIPE_BATCH, PIPE_MICRO, PIPE_STAGES, PIPE_STEPS, PIPE_LR = 64, 8, 4, 4, 0.05
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_TOL = 1e-4
PIPE_UPDATE_RTOL = 1e-3
# (b) GPipe over 4 TransformerBlocks at the LM recipe's width, bf16
GPIPE_BATCH, GPIPE_T, GPIPE_E, GPIPE_HEADS, GPIPE_MICRO = 8, 2048, 512, 8, 4
# (c) Switch-Base-8's published width (Fedus et al. 2021): d_model 768,
# d_ff 3072, 8 experts, capacity factor 1.25; 4096 tokens over 4 expert
# positions; the expert-parallel output against the dense capacity
# oracle's within MOE_RTOL of the oracle's largest element (f32, TF32 off;
# the same 768- and 3072-long dot products over other row sets, so summed
# in another order)
MOE_D, MOE_H, MOE_E, MOE_CF, MOE_TOKENS = 768, 3072, 8, 1.25, 4096
MOE_RTOL = 1e-4
# the tokens' shared mean: the router skewed as the reference's dry run
# skews it (+2.0 * N(0, 1)) drops no unit of centred tokens at this width
# (every expert's share of them is ~1/8); a residual stream's mean makes
# the skewed router favour some experts, so units really drop
MOE_SHIFT = 0.1
# (d) DistriPredictor: 101 images in batches of 32 (the last, 5, padded)
DP_PRED_IMAGES, DP_PRED_BATCH = 101, 32


def _max_share(got, want):
    """max |got - want| / max |want| (0 for two zero tensors)."""
    den = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / den if den else (0.0 if err == 0 else math.inf)


def _pipe_resnet():
    """The ImageNet ResNet-50 (f32, seed 21) with its zero-initialized BN
    gammas drawn from U(0.05, 0.15), as after some training."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import BatchNormalization
    model = ResNet50(class_num=1000, device="cuda",
                     generator=torch.Generator().manual_seed(21))
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization) and not bool(m.weight.any()):
                m.weight.copy_(torch.rand(m.n_output, generator=gen) * 0.1
                               + 0.05)
    return model


def _sgd(pipe, grads, lr):
    with torch.no_grad():
        for st, g in zip(pipe.stages, grads):
            for name, p in st.named_parameters():
                p -= lr * g[name]


def pipeline_1f1b_phase(bk):
    """21(a). Returns kernels 6 and 7's launches over the 4 steps."""
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, ReLU,
                                    SpatialBatchNormalization)
    from bigdl_tpu_torch.parallel import Mesh, PipelineStages, split_sequential
    from bigdl_tpu_torch.tools.pipeline_resnet import microbatch_oracle
    model = _pipe_resnet()
    stages = split_sequential(model, PIPE_STAGES)
    first = stages[0].children_in_order()
    check(isinstance(first[1], SpatialBatchNormalization)
          and type(first[2]) is ReLU,
          "split_sequential(model, 4) cut the stem's BN -> ReLU pair")
    mesh = Mesh(["cuda"] * PIPE_STAGES, ("pipe",))
    micro_b = PIPE_BATCH // PIPE_MICRO
    pipe = PipelineStages(stages, PIPE_MICRO, torch.zeros(
        micro_b, SERVE_HW, SERVE_HW, 3, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.rand(PIPE_BATCH, SERVE_HW, SERVE_HW, 3, generator=gen,
                   device="cuda")
    y = torch.randint(1, 1001, (PIPE_BATCH,), generator=gen, device="cuda")
    crit = ClassNLLCriterion()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}

    def run(step_fn, counted):
        losses, times, peaks, first_grads, counts = [], [], [], None, []
        for _ in range(PIPE_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if counted:
                _reset_bn_counts(bk)
            t0 = time.perf_counter()
            loss, grads = step_fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            if counted:
                counts.append((bk.bn_relu_forward.launches,
                               bk.bn_relu_backward.launches))
            losses.append(float(loss))
            if first_grads is None:
                first_grads = [{n: g.clone() for n, g in st.items()}
                               for st in grads]
            _sgd(pipe, grads, PIPE_LR)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        return losses, times, peaks, first_grads, counts, params

    o_losses, o_ms, o_peak, o_grads, _, o_params = run(
        lambda: microbatch_oracle(pipe, x, y, crit), False)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    losses, ms, peak, grads, counts, params = run(
        lambda: pipe.train_step_1f1b(mesh, x, y, crit), True)
    loss_err = abs(losses[0] - o_losses[0]) / abs(o_losses[0])
    grad_share = max(_max_share(g[n], o[n]) for g, o in zip(grads, o_grads)
                     for n in o)
    shares = {n: _max_share(params[n], o_params[n]) for n in params}
    worst = max(shares, key=shares.get)
    diff = sum(float((params[n] - o_params[n]).double().pow(2).sum())
               for n in params)
    update = sum(float((o_params[n] - init[n]).double().pow(2).sum())
                 for n in params)
    update_err = math.sqrt(diff / update)
    unchanged = all(torch.equal(b, buffers[n])
                    for n, b in model.named_buffers())
    fwd, bwd = BN_SITES * PIPE_MICRO * 2, BN_SITES * PIPE_MICRO
    out = {"model": "ResNet-50 224x224 f32", "batch": PIPE_BATCH,
           "n_micro": PIPE_MICRO, "stages": PIPE_STAGES,
           "stage_children": [len(st.children_in_order()) for st in stages],
           "bubble_fraction": pipe.bubble_fraction,
           "losses": losses, "oracle_losses": o_losses,
           "loss_rel_err_step1": loss_err,
           "grad_max_share_step1": grad_share,
           "update_rel_err_step4": update_err,
           "param_max_share_step4": [worst, shares[worst]],
           "ms_per_step": ms, "oracle_ms_per_step": o_ms,
           "peak_gib": peak, "oracle_peak_gib": o_peak,
           "bn_relu_launches_per_step": counts,
           "buffers_unchanged": unchanged}
    print("pipeline 1f1b " + json.dumps(out), flush=True)
    check(all(math.isfinite(v) for v in losses + o_losses),
          "21(a): a loss is not finite")
    check(loss_err <= PIPE_LOSS_RTOL,
          f"21(a): loss {losses[0]} vs oracle {o_losses[0]}")
    check(grad_share <= PIPE_GRAD_TOL,
          f"21(a): a gradient is {grad_share:.3g} of its largest element "
          f"off the oracle's (limit {PIPE_GRAD_TOL})")
    check(update_err <= PIPE_UPDATE_RTOL,
          f"21(a): the update after {PIPE_STEPS} steps is {update_err:.3g} "
          f"of its norm off the oracle run's (limit {PIPE_UPDATE_RTOL})")
    check(all(c == (fwd, bwd) for c in counts),
          f"21(a): kernels 6/7 launched {counts} a step, want ({fwd}, "
          f"{bwd}): F ticks and B-tick recomputes must take the fused route")
    check(unchanged, "21(a): the pipelined steps changed a BN buffer")
    del pipe, model, stages, init, o_grads, grads
    torch.cuda.empty_cache()
    return {"bn_relu_fwd": sum(c[0] for c in counts),
            "bn_relu_bwd": sum(c[1] for c in counts)}


def gpipe_phase(ak):
    """21(b). Returns kernel 1's launches in one `pipeline_apply`."""
    from bigdl_tpu_torch.nn import TransformerBlock
    from bigdl_tpu_torch.parallel import GPipe, Mesh
    blocks = [TransformerBlock(GPIPE_E, GPIPE_HEADS, causal=True,
                               device="cuda",
                               generator=torch.Generator().manual_seed(s))
              for s in range(4)]
    gp = GPipe(blocks[0], 4, n_micro=GPIPE_MICRO)
    for stage, block in zip(gp.stages, blocks):
        stage.load_state_dict(block.state_dict())
    gp.to(torch.bfloat16).eval()
    mesh = Mesh(["cuda"] * 4, ("pipe",))
    x = torch.randn(GPIPE_BATCH, GPIPE_T, GPIPE_E,
                    generator=torch.Generator().manual_seed(22)).to(
        "cuda", torch.bfloat16)
    with torch.no_grad():
        seq = gp(x)
        _reset_flash_counts(ak)
        got = gp.pipeline_apply(mesh, x)
        torch.cuda.synchronize()
        launches = ak.flash_attention_forward.launches
        ms = cuda_ms(lambda: gp.pipeline_apply(mesh, x), 5)
        seq_ms = cuda_ms(lambda: gp(x), 5)
    diff = (got.float() - seq.float()).abs()
    lim = TOL[torch.bfloat16]["o"] * seq.float().abs().clamp(min=1.0)
    share = float((diff / lim).max())
    out = {"blocks": 4, "width": GPIPE_E, "heads": GPIPE_HEADS,
           "batch": [GPIPE_BATCH, GPIPE_T, GPIPE_E], "dtype": "bfloat16",
           "n_micro": GPIPE_MICRO, "bubble_fraction": gp.bubble_fraction,
           "flash_launches_per_call": launches,
           "bitwise": bool(torch.equal(got, seq)),
           "max_abs_diff": float(diff.max()), "max_share_of_limit": share,
           "ms_per_call": ms, "sequential_ms_per_call": seq_ms}
    print("pipeline gpipe " + json.dumps(out), flush=True)
    check(bool(torch.isfinite(got.float()).all()), "21(b): not finite")
    check(share <= 1, f"21(b): pipelined output {share:.3f} of the bf16 "
          "limit off the sequential forward")
    check(launches == 4 * GPIPE_MICRO,
          f"21(b): kernel 1 launched {launches} times a call, want "
          f"{4 * GPIPE_MICRO}")
    del gp, blocks
    torch.cuda.empty_cache()
    return launches


def moe_phase():
    """21(c): no kernel of the port runs here (the reference's expert
    products are plain einsums)."""
    from bigdl_tpu_torch.parallel import Mesh, MoE
    mesh = Mesh(["cuda"] * 4, ("expert",))
    x = (torch.randn(MOE_TOKENS, MOE_D,
                     generator=torch.Generator().manual_seed(23))
         + MOE_SHIFT).cuda()
    for top_k in (1, 2):
        moe = MoE(MOE_D, MOE_H, MOE_E, MOE_CF, top_k, device="cuda",
                  generator=torch.Generator().manual_seed(23))
        with torch.no_grad():
            moe.router.add_(torch.randn(
                MOE_D, MOE_E, generator=torch.Generator().manual_seed(24)
            ).cuda() * 2.0)
            y, mask = moe.expert_parallel_apply(mesh, x, return_mask=True)
            want, want_mask = moe.dense_capacity_apply(x, 4,
                                                       return_mask=True)
            _, aux = moe.apply_with_aux(x)
            ep_ms = cuda_ms(lambda: moe.expert_parallel_apply(mesh, x), 3)
            cap_ms = cuda_ms(lambda: moe.dense_capacity_apply(x, 4), 3)
            dense_ms = cuda_ms(lambda: moe(x), 3)
        share = _max_share(y, want)
        dropped = int((~mask).sum())
        out = {"top_k": top_k, "d_model": MOE_D, "d_ff": MOE_H,
               "experts": MOE_E, "capacity_factor": MOE_CF,
               "tokens": MOE_TOKENS, "capacity": moe.group_capacity(
                   MOE_TOKENS // 4),
               "dropped_units": dropped, "units": top_k * MOE_TOKENS,
               "masks_equal": bool(torch.equal(mask, want_mask)),
               "max_share": share,
               "aux": {k: (v.tolist() if v.dim() else float(v))
                       for k, v in aux.items()},
               "ms_expert_parallel": ep_ms, "ms_dense_capacity": cap_ms,
               "ms_dense": dense_ms, "kernels": "none"}
        print("pipeline moe " + json.dumps(out), flush=True)
        check(out["masks_equal"], f"21(c) top-{top_k}: drop masks differ")
        check(dropped > 0, f"21(c) top-{top_k}: the skewed router dropped "
              "nothing")
        check(share <= MOE_RTOL and bool(torch.isfinite(y).all()),
              f"21(c) top-{top_k}: outputs {share:.3g} of the largest "
              f"element apart (limit {MOE_RTOL})")
        del moe
    torch.cuda.empty_cache()


def distri_predictor_phase(sk, bk):
    """21(d). Returns kernels 5 and 6's launches."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.optim import DistriPredictor, LocalPredictor
    from bigdl_tpu_torch.parallel import Mesh
    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n_cards)] \
        if n_cards > 1 else ["cuda"] * 2
    mesh = Mesh(devices, ("data",))
    images = np.random.RandomState(21).rand(
        DP_PRED_IMAGES, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    _randomize_bn_state(model, 0)
    os.environ[STEM_ENV] = "1"
    try:
        local = LocalPredictor(model, DP_PRED_BATCH, device="cuda")
        ref = np.stack(local.predict(images))
        ref_cls = local.predict_class(images)
        pred = DistriPredictor(model, DP_PRED_BATCH, mesh)
        _reset_stem_counts(sk, bk)
        t0 = time.perf_counter()
        got = np.stack(pred.predict(images))
        wall = time.perf_counter() - t0
        launches = _stem_counts(sk, bk)
        cls = pred.predict_class(images)
    finally:
        os.environ.pop(STEM_ENV, None)
    batches = -(-DP_PRED_IMAGES // DP_PRED_BATCH)
    distinct = len(set(mesh.axis_devices("data")))
    share, clear = _check_rows(got, ref, "21(d) DistriPredictor")
    out = {"images": DP_PRED_IMAGES, "batch_size": DP_PRED_BATCH,
           "mesh": [str(d) for d in mesh.axis_devices("data")],
           "batches": batches, "distinct_devices": distinct,
           "launches": {"stem_conv": launches[0],
                        "bn_relu_fwd": launches[1]},
           "max_share_of_limit": share, "argmax_rows_checked": clear,
           "classes_equal": cls == ref_cls, "wall_s": wall,
           "images_per_sec": DP_PRED_IMAGES / wall}
    print("pipeline distri_predictor " + json.dumps(out), flush=True)
    check(cls == ref_cls, "21(d): predict_class differs from LocalPredictor")
    check(launches == (batches * distinct, batches * distinct),
          f"21(d): kernels 5/6 launched {launches}, want "
          f"{batches * distinct} each (one forward per distinct device per "
          "batch)")
    del pred, local, model
    torch.cuda.empty_cache()
    return {"stem_conv": launches[0], "bn_relu_fwd": launches[1]}


def pipeline_phase(ak, sk, bk):
    """21: (a)-(d) and the phase's wall time; returns the launches of
    kernels 1, 5, 6 and 7 on its paths."""
    t0 = time.perf_counter()
    bn = pipeline_1f1b_phase(bk)
    flash = gpipe_phase(ak)
    moe_phase()
    served = distri_predictor_phase(sk, bk)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"flash_attention_fwd": {"gpipe_call": flash},
            "stem_conv": {"distri_predictor": served["stem_conv"]},
            "bn_relu_fwd": {"1f1b": bn["bn_relu_fwd"],
                            "distri_predictor": served["bn_relu_fwd"]},
            "bn_relu_bwd": {"1f1b": bn["bn_relu_bwd"]}}


# 22: the operations stack. (a) ResNet-50 b128 from 8 seeded raw host
# batches (uint8, 256x256x3) through a numpy chain (random 224 crop,
# horizontal flip, normalize), serial and prefetched (`set_prefetch`,
# P22_WORKERS threads); the same steps (8 warm-up + 24) and sync as
# phase 6, under `Deterministic` so the two runs' losses may be compared
# bit for bit. (b) phase 20(a)'s fleet drill watched by an `SloEngine`
# and a `PrometheusTextSink` served on 127.0.0.1:0. (c) (a)'s serial run
# with the `SloEngine` and the Prometheus sink attached.
P22_BATCHES, P22_BATCH, P22_RAW, P22_CROP = 8, 128, 256, 224
P22_WARMUP, P22_ITERS, P22_SYNC = 8, 24, 8
P22_WORKERS = 4
P22_PARAM_EVERY = 8
# the mean and std of `normalize`, per channel (ImageNet's)
P22_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
P22_STD = np.array([0.229, 0.224, 0.225], np.float32)
# `slo_status` records this often in record time, so the last scrape
# holds every objective's burn rate after the drill's recovery
P22_SLO_EVERY_S = 0.05
# 22(b)'s drills in order, watched or not: unwatched, watched, watched,
# unwatched, so drift over the phase weighs on both kinds alike
P22_DRILLS = (False, True, True, False)
# each request's deadline in the drill, and the gate's latency ceiling
# (`slo --check --latency-p99-ms`): the reference's replay drill holds its
# fleet to `default_slos(latency_p99_ms=deadline_ms)`. The default 100 ms
# is the ceiling of the reference's fleet of a 784-64-10 MLP; three f32
# ResNet-50 replicas sharing one card with 24 requests in flight miss it,
# so the phase prints that verdict beside the gate, and the engines' tail
# (p50, p99, max, requests over 100 and 500 ms) of every drill
P22_DEADLINE_MS = 15_000.0


class _P22Source:
    """The raw batches in a fixed cycle (`shuffle` keeps the order), so a
    serial and a prefetched run see the same stream across epochs."""

    def __init__(self, items):
        self.items = items

    def data(self, train):
        return itertools.cycle(self.items) if train else iter(self.items)

    def size(self):
        return P22_BATCHES * P22_BATCH

    def shuffle(self):
        pass

    def position(self):
        return {}

    def transform(self, transformer):
        from bigdl_tpu_torch.dataset.dataset import _TransformedDataSet
        return _TransformedDataSet(self, transformer)


def _p22_crop_flip(item):
    """(k, raw uint8 [B, 256, 256, 3], labels) -> the random 224 crop of
    each image, half of them flipped; the draws from RandomState(k), so
    a batch's crop is the same whichever thread makes it."""
    k, raw, y = item
    rs = np.random.RandomState(1000 + k)
    off = rs.randint(0, P22_RAW - P22_CROP + 1, size=(len(raw), 2))
    flip = rs.rand(len(raw)) < 0.5
    out = np.empty((len(raw), P22_CROP, P22_CROP, 3), np.uint8)
    for i, (oy, ox) in enumerate(off):
        img = raw[i, oy:oy + P22_CROP, ox:ox + P22_CROP]
        out[i] = img[:, ::-1] if flip[i] else img
    return k, out, y


def _p22_normalize(item):
    """(x / 255 - mean) / std per channel, as f32, in two passes over
    the batch after the cast."""
    from bigdl_tpu_torch.dataset import MiniBatch
    _, x, y = item
    x = x.astype(np.float32)
    x *= np.float32(1 / 255) / P22_STD
    x -= P22_MEAN / P22_STD
    return MiniBatch(x, y)


@functools.lru_cache(maxsize=1)
def _p22_items():
    """The raw host batches: (k, uint8 images, 1-based labels), seed 22."""
    rs = np.random.RandomState(22)
    return tuple((k, rs.randint(0, 256, size=(P22_BATCH, P22_RAW, P22_RAW, 3),
                                dtype=np.uint8),
                  (rs.randint(0, 1000, P22_BATCH) + 1).astype(np.int32))
                 for k in range(P22_BATCHES))


def _p22_dataset():
    from bigdl_tpu_torch.dataset import FuncTransformer
    return _P22Source(list(_p22_items())).transform(
        FuncTransformer(_p22_crop_flip) >> FuncTransformer(_p22_normalize))


def _p22_run(bk, prefetch, tmp, watch=False, summaries=False):
    """One (a) run: the losses, the records, the ms a step, the launches
    of kernels 6-7, and the summaries' directory."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import (InMemorySink, JsonlSink,
                                               PrometheusTextSink, SloEngine,
                                               Telemetry, default_slos)
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, Top1Accuracy,
                                       max_iteration, several_iteration)
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary
    threads = threading.active_count()
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = DistriOptimizer(model, _p22_dataset(), ClassNLLCriterion(),
                          devices=["cuda"])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_compute_precision("bfloat16")
    opt.set_sync_interval(P22_SYNC)
    opt.set_end_when(max_iteration(P22_WARMUP + P22_ITERS))
    sink = InMemorySink()
    stream = os.path.join(tmp, f"train_{int(prefetch)}{int(watch)}.jsonl")
    sinks = [sink, JsonlSink(stream)]
    if watch:
        sinks.append(PrometheusTextSink())
    tel = Telemetry(*sinks, resources=False, flight=False)
    if watch:
        SloEngine(default_slos(), emit_every_s=P22_SLO_EVERY_S).attach(tel)
    opt.set_telemetry(tel)
    if prefetch:
        opt.set_prefetch(workers=P22_WORKERS)
    logdir = tag = None
    if summaries:
        from bigdl_tpu_torch.interop import params_tree
        from bigdl_tpu_torch.optim.local_optimizer import _flat_tree
        tag = next(_flat_tree(params_tree(model)))[0]
        logdir = os.path.join(tmp, "tb")
        ts = TrainSummary(logdir, "resnet50")
        ts.set_summary_trigger("Parameters",
                               several_iteration(P22_PARAM_EVERY))
        vs = ValidationSummary(logdir, "resnet50")
        opt.set_train_summary(ts).set_validation_summary(vs)
        held = _p22_normalize(_p22_crop_flip(_p22_items()[0]))
        opt.set_validation(several_iteration(P22_WARMUP + P22_ITERS),
                           [held], [Top1Accuracy()])
    losses, times = [], []

    def hook(state):
        losses.append(opt.last_loss)
        if state["neval"] % P22_SYNC == 0:  # the device has drained here
            times.append(time.perf_counter())

    opt.set_iteration_hook(hook)
    _reset_bn_counts(bk)
    with Deterministic():
        opt.optimize()
    launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    tel.close()
    if summaries:
        ts.close()
        vs.close()
    # ms a step: the step records' windows after the warm-up (the sync
    # window leaves out each sync point's tail: summaries, validation);
    # the hook's drained points give the wall time with that tail
    windows = [r["step_time_s"] for r in sink.records
               if r["type"] == "step" and r["step"] > P22_WARMUP]
    ms = float(np.median(windows)) * 1e3
    wall_ms = float(np.median(np.diff(
        times[P22_WARMUP // P22_SYNC - 1:]))) / P22_SYNC * 1e3
    out = {"losses": [float(v) for v in losses], "records": sink.records,
           "wall_ms_per_step": wall_ms,
           "stream": stream, "ms_per_step": ms,
           "imgs_per_sec": P22_BATCH / ms * 1e3, "launches": launches,
           "threads_left": threading.active_count() - threads,
           "logdir": logdir, "hist_tag": tag}
    del model, opt
    torch.cuda.empty_cache()
    return out


def ops_training_phase(bk, tmp):
    """22(a) and (c); returns kernels 6 and 7's launches over the runs."""
    from bigdl_tpu_torch.tools import metrics_cli
    from bigdl_tpu_torch.visualization import FileReader
    steps = P22_WARMUP + P22_ITERS
    serial = _p22_run(bk, False, tmp)
    pre = _p22_run(bk, True, tmp, summaries=True)
    watched = _p22_run(bk, False, tmp, watch=True)
    out = {}
    for name, r in (("serial", serial), ("prefetch", pre),
                    ("serial_watched", watched)):
        steps_recs = [x for x in r["records"] if x["type"] == "step"]
        out[name] = {"ms_per_step": r["ms_per_step"],
                     "imgs_per_sec": r["imgs_per_sec"],
                     "wall_ms_per_step": r["wall_ms_per_step"],
                     "launches": r["launches"],
                     "threads_left": r["threads_left"],
                     "loss_first": r["losses"][0],
                     "loss_last": r["losses"][-1],
                     "step_time_s": [x["step_time_s"] for x in steps_recs],
                     "prefetch": [{k: v for k, v in x.items()
                                   if k.startswith("prefetch_")}
                                  for x in steps_recs]}
    out["watch_cost_ms_per_step"] = \
        watched["ms_per_step"] - serial["ms_per_step"]
    recs = pre["records"]
    compiles = [x for x in recs if x["type"] == "compile"]
    steps_recs = [x for x in recs if x["type"] == "step"]
    tb = os.path.join(pre["logdir"], "resnet50")
    scalars = FileReader.read_scalar(os.path.join(tb, "train"), "Loss")
    top1 = FileReader.read_scalar(os.path.join(tb, "validation"),
                                  "Top1Accuracy")
    report = metrics_cli.report(pre["stream"], out=io.StringIO())
    out.update({"compile": compiles, "summary_loss": scalars,
                "validation_top1": top1, "report_rc": report})
    print("ops training " + json.dumps(out), flush=True)
    check(serial["losses"] == pre["losses"]
          and all(np.isfinite(serial["losses"])),
          "ops: serial and prefetched losses differ: "
          f"{serial['losses'][:4]} vs {pre['losses'][:4]}")
    for name in ("serial", "prefetch", "serial_watched"):
        # the prefetched run also validates one batch (kernel 6 only)
        val = int(name == "prefetch")
        check(out[name]["launches"] == (BN_SITES * (steps + val),
                                        BN_SITES * steps),
              f"ops {name}: kernels 6/7 launched {out[name]['launches']}, "
              f"not {BN_SITES} x ({steps} + {val}) and {BN_SITES} x "
              f"{steps}")
        check(out[name]["threads_left"] == 0,
              f"ops {name}: {out[name]['threads_left']} threads left")
    check(all(set(p) == {"prefetch_queue_depth", "prefetch_fetch_wait_s",
                         "prefetch_worker_busy"}
              for p in out["prefetch"]["prefetch"]),
          "ops: a prefetched step record lacks its gauges")
    check(len(compiles) == 1 and compiles[0]["flops"]
          == steps_recs[0]["flops_per_step"] > 0,
          f"ops: compile records {compiles} against flops_per_step "
          f"{steps_recs[0].get('flops_per_step')}")
    check([v for _, v in scalars] ==
          [float(np.float32(x["loss"])) for x in steps_recs]
          and [s for s, _ in scalars] == [x["step"] for x in steps_recs],
          f"ops: summary losses {scalars} against the step records")
    n_hist = len(FileReader.read_histogram(os.path.join(tb, "train"),
                                           pre["hist_tag"]))
    check(n_hist == steps // P22_PARAM_EVERY,
          f"ops: {n_hist} Parameters histograms of {pre['hist_tag']}")
    check(len(top1) == 1, f"ops: validation scalars {top1}")
    check(report == 0, f"ops: metrics_cli report exited {report}")
    return {k: serial["launches"][i] + pre["launches"][i]
            + watched["launches"][i]
            for i, k in enumerate(("bn_relu_fwd", "bn_relu_bwd"))}


def _scrape(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def _ops_drill(model, samples, tmp, tag, watched):
    """One phase-20(a) drill with its crash over a fresh fleet of
    FLEET_REPLICAS engines; the stream goes to `<tmp>/<tag>.jsonl`.
    `watched` adds a live `SloEngine(default_slos())`, a
    `PrometheusTextSink` tracking every replica and a `MetricsServer` on
    127.0.0.1:0 scraped every 0.1 s during the drill and once after it;
    nothing else differs between a watched and an unwatched drill."""
    from bigdl_tpu_torch.observability import (InMemorySink, JsonlSink,
                                               MetricsServer,
                                               PrometheusTextSink, SloEngine,
                                               Telemetry, default_slos)
    from bigdl_tpu_torch.serving import InferenceEngine, ServingFleet
    from bigdl_tpu_torch.tools.bench import serve_fleet_drill
    stream = os.path.join(tmp, f"{tag}.jsonl")
    sink = InMemorySink()
    prom = PrometheusTextSink() if watched else None
    tel = Telemetry(sink, JsonlSink(stream), *([prom] if watched else []),
                    resources=False, flight=False)
    slo = (SloEngine(default_slos(), emit_every_s=P22_SLO_EVERY_S)
           .attach(tel) if watched else None)
    engines = []

    def factory(rid):
        eng = InferenceEngine(model, max_batch_size=FLEET_BATCH,
                              max_wait_ms=1.0, queue_capacity=256,
                              admission="reject", telemetry=tel,
                              replica_id=rid, emit_every=4,
                              breaker={"failure_threshold": 5,
                                       "reset_timeout_s": 30.0},
                              device="cuda")
        engines.append(eng)
        if watched:
            prom.track_engine(eng, name=rid)
        return eng

    live, stop, final = [], threading.Event(), None
    server = (MetricsServer(prom, host="127.0.0.1", port=0)
              if watched else None)

    def scraper():
        while not stop.is_set():
            live.append(_scrape(server.url))
            stop.wait(0.1)

    try:
        if watched:
            # one scrape before the drill: the first use of this process's
            # HTTP client (~60 ms of Python on a CPU) would otherwise land
            # on the drill's first requests, and a deployment's scraper
            # runs in another process
            _scrape(server.url)
        fleet = ServingFleet(engine_factory=factory,
                             n_replicas=FLEET_REPLICAS,
                             warmup_sample=samples[0], telemetry=tel,
                             drain_grace_s=0.5, lease_s=30.0)
        t = threading.Thread(target=scraper, daemon=True)
        try:
            if watched:
                t.start()
            out, rows = serve_fleet_drill(fleet, samples, sink,
                                          FLEET_CLIENTS, FLEET_PER_CLIENT,
                                          crash=True,
                                          deadline_ms=P22_DEADLINE_MS)
        finally:
            stop.set()
            if watched:
                t.join(timeout=30)
            fleet.close()
        if watched:
            slo.finalize()
        tel.close()
        if watched:
            final = _scrape(server.url)
    finally:
        if watched:
            server.close()
    # the engines' own latencies, which the latency objective reads: one
    # status-ok `trace` record a request, stamped when it resolved
    traces = [r for r in sink.records
              if r["type"] == "trace" and r.get("status") == "ok"]
    lat = np.array([r["latency_ms"] for r in traces])
    t_lost = next(r["time"] for r in sink.records
                  if r.get("event") == "worker_lost")
    t_first = min(r["time"] - r["latency_ms"] / 1e3 for r in traces)
    worst = sorted(traces, key=lambda r: -r["latency_ms"])[:5]
    tail = {"latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_ms_max": float(lat.max()),
            "over_100ms": int((lat > 100).sum()),
            "over_500ms": int((lat > 500).sum()),
            # the five slowest: latency, and arrival (s) after the first
            # request's and against the loss
            "slowest": [(r["latency_ms"], round(t - t_first, 4),
                         round(t - t_lost, 4))
                        for r in worst
                        for t in [r["time"] - r["latency_ms"] / 1e3]],
            "loss_after_first_s": round(t_lost - t_first, 4)}
    want = sum(e.stats()["batches"] + len(e.buckets) for e in engines)
    return {"tag": tag, "watched": watched, "stream": stream, "out": out,
            "rows": rows, "live": live, "final": final, "want": want,
            "engine": tail, "slo": slo,
            "compile_records": sum(r["type"] == "compile"
                                   for r in sink.records)}


def ops_fleet_phase(sk, bk, tmp):
    """22(b): phase 20(a)'s drill, unwatched and watched live in the order
    of P22_DRILLS; returns kernels 5 and 6's launches over the drills."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.tools import metrics_cli
    images = _fleet_images()
    model, ref = _fleet_model_and_ref(images)
    samples = [Sample(x) for x in images]
    os.environ[STEM_ENV] = "1"
    _reset_stem_counts(sk, bk)
    try:
        drills = [_ops_drill(model, samples, tmp, f"drill{i}", w)
                  for i, w in enumerate(P22_DRILLS)]
    finally:
        os.environ.pop(STEM_ENV, None)
    launches = _stem_counts(sk, bk)
    want = sum(d["want"] for d in drills)
    # the gates: every drill's stream at the deadline's ceiling (the first
    # watched drill's table printed); the cut and the diff on that stream
    watched = next(d for d in drills if d["watched"])
    stream = watched["stream"]
    table, default = io.StringIO(), io.StringIO()
    gates = {d["tag"]: metrics_cli.slo(
        [d["stream"]], check=True, mttr_s=60.0,
        latency_p99_ms=P22_DEADLINE_MS,
        out=table if d is watched else io.StringIO()) for d in drills}
    with open(stream) as f:
        lines = f.readlines()
    lost = next(i for i, line in enumerate(lines)
                if '"worker_lost"' in line)
    cut = os.path.join(tmp, "fleet_cut.jsonl")
    with open(cut, "w") as f:
        f.writelines(lines[:lost + 1])
    changed = os.path.join(tmp, "fleet_changed.jsonl")
    first_ok = next(i for i, line in enumerate(lines)
                    if '"type": "trace"' in line and '"status": "ok"' in line)
    with open(changed, "w") as f:
        f.writelines(lines[:first_ok]
                     + [lines[first_ok].replace('"status": "ok"',
                                                '"status": "error"')]
                     + lines[first_ok + 1:])
    defaults = {d["tag"]: metrics_cli.slo(
        [d["stream"]], check=True, mttr_s=60.0,
        out=default if d is watched else io.StringIO()) for d in drills}
    cut_table = io.StringIO()
    gates.update({
        "slo_check_cut": metrics_cli.slo([cut], check=True, mttr_s=60.0,
                                         latency_p99_ms=P22_DEADLINE_MS,
                                         out=cut_table),
        "diff_self": metrics_cli.diff(stream, stream, out=io.StringIO()),
        "diff_changed": metrics_cli.diff(stream, changed,
                                         out=io.StringIO())})
    families = {
        "serving_counters": "bigdl_tpu_serving_completed_total",
        "breaker_gauges": "bigdl_tpu_serving_breaker_state{bucket=",
        "fleet_gauges": "bigdl_tpu_serving_fleet_replicas_alive",
        **{f"burn_{s.name}": f'bigdl_tpu_slo_burn_rate{{slo="{s.name}"}}'
           for s in watched["slo"].slos}}
    per = {}
    for d in drills:
        out = d["out"]
        per[d["tag"]] = {
            "watched": d["watched"], "engine": d["engine"],
            "compile_records": d["compile_records"],
            **{k: out[k] for k in ("ok", "timed_out", "rerouted", "other",
                                   "reroutes", "drains", "mttr_s",
                                   "recovered", "wall_s",
                                   "requests_per_sec", "latency_ms_p50",
                                   "latency_ms_p99")}}
        if d["watched"]:
            per[d["tag"]].update({
                "live_scrapes": len(d["live"]),
                "live_holds": {k: any(v in text for text in d["live"])
                               for k, v in families.items()},
                "final_holds": {k: v in d["final"]
                                for k, v in families.items()},
                "slo_status": d["slo"].status()})
    got = {"drills": per, "gates": gates,
           "slo_check_default_ceiling": defaults,
           "launches": {"stem_conv": launches[0],
                        "bn_relu_fwd": launches[1]},
           # the cost of watching the drill: each kind's client p99 and
           # engine p99 (ms) and requests/s, in drill order
           "watch_ab": {kind: {
               "client_p99": [per[d["tag"]]["latency_ms_p99"]
                              for d in drills if d["watched"] == w],
               "engine_p99": [per[d["tag"]]["engine"]["latency_ms_p99"]
                              for d in drills if d["watched"] == w],
               "requests_per_sec": [per[d["tag"]]["requests_per_sec"]
                                    for d in drills if d["watched"] == w]}
               for kind, w in (("unwatched", False), ("watched", True))}}
    print("ops fleet " + json.dumps(got), flush=True)
    print("slo --check --mttr-s 60 (default 100 ms ceiling):\n"
          + default.getvalue(), flush=True)
    print(f"slo --check --mttr-s 60 --latency-p99-ms {P22_DEADLINE_MS}:"
          f"\n" + table.getvalue(), flush=True)
    total = FLEET_CLIENTS * FLEET_PER_CLIENT
    for d in drills:
        out = d["out"]
        check(out["ok"] + out["timed_out"] + out["rerouted"] == total
              and out["other"] == 0 and out["drains"] == 1
              and out["recovered"], f"ops fleet {d['tag']}: outcomes {out}")
        idx = [i for i, _ in d["rows"]]
        _check_rows(np.stack([r for _, r in d["rows"]]), ref[idx],
                    f"ops fleet {d['tag']}")
        if d["watched"]:
            p = per[d["tag"]]
            check(p["live_scrapes"] >= 1 and p["live_holds"]["fleet_gauges"],
                  f"ops fleet {d['tag']}: live scrapes "
                  f"{p['live_scrapes']}, {p['live_holds']}")
            check(all(p["final_holds"].values()),
                  f"ops fleet {d['tag']}: the last scrape lacks "
                  f"{p['final_holds']}")
    check(gates == {**{d["tag"]: 0 for d in drills}, "slo_check_cut": 1,
                    "diff_self": 0, "diff_changed": 1},
          f"ops fleet: gates {gates}")
    # the cut stream fails on the loss it never recovered from alone
    check("VIOLATED: training_mttr\n" in cut_table.getvalue(),
          f"ops fleet: the cut stream's table\n{cut_table.getvalue()}")
    check(launches == (want, want),
          f"ops fleet: launches (stem, BN+ReLU) {launches} != batches + "
          f"warm-up buckets {want} over {len(drills)} fleets")
    del model
    torch.cuda.empty_cache()
    return launches


def ops_phase(sk, bk):
    """22: (a)-(c) and the phase's wall time; returns the launches of
    kernels 5, 6 and 7 on its paths."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train = ops_training_phase(bk, tmp)
        stem, bn = ops_fleet_phase(sk, bk, tmp)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"stem_conv": {"fleet": stem},
            "bn_relu_fwd": {"training": train["bn_relu_fwd"], "fleet": bn},
            "bn_relu_bwd": {"training": train["bn_relu_bwd"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--tp-child"]:
        return tp_child(*sys.argv[2:5])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    from bigdl_tpu_torch.observability import costs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    from bigdl_tpu_torch.ops import stem_kernel as sk

    # the bf16 tensor-core peak of the bounds: the card's registry entry
    PEAK_FLOPS[torch.bfloat16] = costs.peak_flops(
        torch.cuda.get_device_name(0))
    check(PEAK_FLOPS[torch.bfloat16] is not None,
          f"{torch.cuda.get_device_name(0)!r} has no entry in "
          "costs.PEAK_BF16_FLOPS")

    # 2. build
    t0 = time.perf_counter()
    _build.build_kernels()
    print(f"build: {len(_build.KERNELS)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    tc_build = build_phase(_build)

    if sys.argv[1:2] in (["--phase17"], ["--phase18"], ["--phase19"],
                         ["--phase20"], ["--phase21"], ["--phase22"]):
        if sys.argv[1] == "--phase17":
            observability_phase(ak, sk, bk)
        elif sys.argv[1] == "--phase18":
            elastic_phase(ak)
        elif sys.argv[1] == "--phase19":
            quantization_phase(sk, bk)
        elif sys.argv[1] == "--phase20":
            fleet_phase(ak, sk, bk)
        elif sys.argv[1] == "--phase21":
            pipeline_phase(ak, sk, bk)
        else:
            ops_phase(sk, bk)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernel
    main_row = kernel_phase(ak)

    # 4. generation
    launches = generation_phase(ak)

    # 5. BN+ReLU kernels
    t0 = time.perf_counter()
    bn_rows = bn_relu_phase(bk)
    bn_sites = bn_sites_phase(bk)
    print("phase 5 profile windows "
          + json.dumps(profile_window_summary()), flush=True)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. training
    bn_launches, resnet_res = training_phase(bk)

    # 7. flash backward kernels
    bwd_rows = flash_backward_phase(ak)

    # 8. LM training
    lm_launches, lm_res = lm_training_phase(ak)

    # 9. sequence parallelism
    carry_row = carry_phase(ak)
    carry_launches, long_context = sequence_parallel_phase(ak)

    # 10. the space-to-depth stem
    stem_row = stem_kernel_phase(sk)
    stem_launches = stem_serving_phase(sk, bk, stem_row["ms"])
    stem_training_phase(sk)

    # 11. the training loop's accounting and safety net
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model, held, rtol = resume_phase(bk, tmp)
        retry_phase(tmp, rtol)
        evaluator_phase(model, held)
    del model, held
    torch.cuda.empty_cache()
    lm_loop_phase(ak, lm_res["losses"])
    mfu_phase(resnet_res, lm_res)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    # 12. the feed-forward zoo
    t0 = time.perf_counter()
    zoo_rows = zoo_kernel_phase(sk, bk)
    print("phase 12 profile windows "
          + json.dumps(profile_window_summary()), flush=True)
    zoo_pairs = zoo_parity_phase(sk, bk)
    zoo_bench = zoo_bench_phase(sk, bk)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the recurrent path and the rest of the training loop
    t0 = time.perf_counter()
    recurrent_parity_phase()
    ptb_bench_phase(ak, sk, bk)
    lm_example_phase()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)

    # 14. data parallel
    t0 = time.perf_counter()
    dp_rows = bn_relu_phase(
        bk, [("stem b64", 64 * 112 * 112, 64),
             ("last stage b64", 64 * 7 * 7, 512)],
        [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)],
        main="stem b64")
    dp_one_rank_phase(bk)
    with tempfile.TemporaryDirectory() as tmp:
        dp_full, _ = dp_phase(bk, tmp)
    dp_launches = [f["bn_relu_launches_per_step"] for f in dp_full]
    dp_steps = DP_WARMUP + DP_ITERS
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    # 15. Wide&Deep
    t0 = time.perf_counter()
    wd_parity_phase()
    wd_bench_phase(ak, sk, bk)
    wd_profile_phase()
    wd_example_phase()
    wd_serving_phase()
    wd_dp_phase()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. tensor parallelism and sharded checkpoints
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tp_parity_phase(tmp)
    tp_launches = tp_bench_phase()
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)

    # 17. the observability core
    obs_launches = observability_phase(ak, sk, bk)

    # 18. elastic training and preemption
    elastic_launches, preempt_launches = elastic_phase(ak)

    # 19. int8 post-training quantization
    int8_launches = quantization_phase(sk, bk)

    # 20. the serving fleet
    fleet_launches = fleet_phase(ak, sk, bk)

    # 21. pipeline and expert parallelism, DistriPredictor
    pipe_launches = pipeline_phase(ak, sk, bk)

    # 22. the operations stack
    ops_launches = ops_phase(sk, bk)
    zoo_launches = {
        "launches_inception_v1": zoo_bench["inception_v1"]["launches"],
        "launches_inception_v2": zoo_bench["inception_v2"]["launches"],
        "launches_vgg_cifar": zoo_pairs["vgg_cifar"]}

    print(json.dumps({"kernels": [
        {**KERNEL_ROW, "launches": launches, **main_row, "status": "ok",
         "launches_lm_training": lm_launches["flash_attention_fwd"],
         "training_shape": {**bwd_rows["fwd_training_shape"],
                            "design": DESIGN[torch.bfloat16]},
         "long_context_shape": long_context,
         "launches_tp_ranks": tp_launches["flash_attention_fwd"],
         "launches_observed_lm": obs_launches["flash_attention_fwd"],
         "launches_preempt_lm": preempt_launches["flash_attention_fwd"],
         "launches_fleet": fleet_launches["flash_attention_fwd"],
         "launches_pipeline": pipe_launches["flash_attention_fwd"],
         "build": tc_build["flash_attention_fwd"]},
        {**CARRY_ROW, "launches": carry_launches, **carry_row,
         "design": DESIGN[torch.bfloat16],
         "build": tc_build["flash_attention_carry"], "status": "ok"},
        {**DQ_ROW, "launches": lm_launches["flash_attention_bwd_dq"],
         **bwd_rows["dq"], "design": DESIGN[torch.bfloat16],
         "launches_tp_ranks": tp_launches["flash_attention_bwd_dq"],
         "launches_observed_lm": obs_launches["flash_attention_bwd_dq"],
         "launches_preempt_lm": preempt_launches["flash_attention_bwd_dq"],
         "build": tc_build["flash_attention_bwd_dq"], "status": "ok"},
        {**DKV_ROW, "launches": lm_launches["flash_attention_bwd_dkv"],
         **bwd_rows["dkv"], "design": DESIGN[torch.bfloat16],
         "launches_tp_ranks": tp_launches["flash_attention_bwd_dkv"],
         "launches_observed_lm": obs_launches["flash_attention_bwd_dkv"],
         "launches_preempt_lm": preempt_launches["flash_attention_bwd_dkv"],
         "build": tc_build["flash_attention_bwd_dkv"], "status": "ok"},
        *[{**row, "launches": bn_launches[row["name"]],
           **bn_rows[d], "design": BN_DESIGN[row["name"]], "status": "ok",
           "x_f32_stem": bn_rows[f"{d}_x_f32"],
           "resnet50_sites": [{"site": r["site"],
                               "device_ms": r[f"{d}_device_ms"],
                               "bound_ms": r[f"{d}_bound_ms"]}
                              for r in bn_sites["sites"]],
           "resnet50_step_device_ms": bn_sites["step"][f"{d}_device_ms"],
           **{k: v[row["name"]] for k, v in zoo_launches.items()},
           "zoo_shapes": zoo_rows[d],
           "launches_dp_ranks": [l[d] * dp_steps for l in dp_launches],
           "launches_elastic": elastic_launches[row["name"]],
           "launches_pipeline": pipe_launches[row["name"]],
           "launches_ops": ops_launches[row["name"]],
           **({"launches_int8_serving": int8_launches["bn_relu_fwd"],
               "launches_fleet": fleet_launches["bn_relu_fwd"]}
              if d == "fwd" else {}),
           "dp_rank_shape": dp_rows[d]}
          for row, d in ((BN_FWD_ROW, "fwd"), (BN_BWD_ROW, "bwd"))],
        {**STEM_ROW, "launches": stem_launches, **stem_row,
         "build": tc_build["stem_conv"], "status": "ok",
         "launches_int8_serving": int8_launches["stem_conv"],
         "launches_fleet": fleet_launches["stem_conv"],
         "launches_pipeline": pipe_launches["stem_conv"],
         "launches_ops": ops_launches["stem_conv"],
         **{k: v["stem_conv"] for k, v in zoo_launches.items()},
         "zoo_shapes": zoo_rows["stem"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
