"""Pipeline parallelism: GPipe and 1F1B over a "pipe" mesh axis
(counterpart of `bigdl_tpu/parallel/pipeline.py`).

The JAX package runs one SPMD program over the "pipe" axis: each device
holds one stage, activations move with `lax.ppermute`, and a `lax.scan`
over ticks runs the schedule. The port keeps the single-controller model
of `parallel/sequence.py`: one process walks the same schedule, runs
stage s on position s's device of the mesh's "pipe" axis, and moves each
activation (and, in 1F1B, each gradient) to the next stage's device, a
no-op when both stages share a device (n stages on one card).

- `GPipe`: `n_stages` copies of one block; `pipeline_apply` runs the
  fill-drain schedule over `n_micro` microbatches.
- `PipelineStages`: any per-stage modules. `pipeline_apply` is GPipe's
  fill-drain forward; `train_step_1f1b` walks the reference's static
  1F1B table (`_schedule_1f1b`, copied verbatim): an F tick runs a
  stage's forward without autograd and banks the output as the next
  stage's stashed input; a B tick recomputes the stage's forward under
  autograd from the stashed input and takes the parameter and input
  gradients with `torch.autograd.grad`, seeded with `1/M` at the last
  stage (M microbatches) or with the gradient the next stage banked.
  The reference moves activations and parameters through a padded flat
  f32 contract, which only SPMD's fixed shapes need; the port moves
  activations in their own shapes and dtypes (the same values) and keeps
  the parameters in the stage modules.
- `split_sequential`: a `Sequential`'s children as contiguous stages.

State: the reference's pipelined paths apply every stage with a fresh
context and drop the new state, so they never update BN's running
statistics. The port's BN updates its buffers in every training forward
(and a B tick's recompute would update them a second time), so both
pipelined paths leave every buffer and every module's mode as they found
them (`run_scope`). Outputs and gradients are those of the reference:
in training each microbatch is normalized by its own statistics.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.optim.predictor import model_device

#: the parameter dtypes the pipelined paths take (the reference's f32
#: round-trip contract)
_PIPE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _pipe_devices(mesh, n_stages: int) -> List[torch.device]:
    """The devices of the mesh's "pipe" axis; a `ValueError` naming it
    unless it has one position a stage."""
    mesh_pipe = int(mesh.shape.get("pipe", 0))
    if mesh_pipe != n_stages:
        raise ValueError(
            f"mesh 'pipe' axis has {mesh_pipe} devices but the "
            f"pipeline has {n_stages} stages")
    return mesh.axis_devices("pipe")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


@contextlib.contextmanager
def run_scope(modules: Sequence[nn.Module], training: bool):
    """Run `modules` in training mode `training` and leave them as found:
    every submodule's mode, and every buffer a forward wrote (BN's running
    statistics), put back bit for bit. A buffer nothing wrote is not
    touched (its version counter decides), so an autograd graph that
    saved it stays valid."""
    mods = list(modules)
    modes = [(m, m.training) for mod in mods for m in mod.modules()]
    saved = [(b, b._version, b.detach().clone())
             for mod in mods for b in mod.buffers()]
    for mod in mods:
        mod.train(training)
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode
        with torch.no_grad():
            for b, version, old in saved:
                if b._version != version:
                    b.copy_(old)


def _fill_drain(stages, devs, micro):
    """GPipe's fill-drain order: at tick t stage s runs microbatch t - s
    on its device and hands its output to stage s + 1's device. The idle
    fill and drain ticks compute nothing that reaches the output, so they
    are skipped. Returns the last stage's outputs in microbatch order."""
    n_stages, n_micro = len(stages), len(micro)
    held, outs = {}, [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = micro[m].to(devs[0]) if s == 0 else held.pop((s, m))
            y = stages[s](h)
            if s + 1 < n_stages:
                held[(s + 1, m)] = y.to(devs[s + 1])
            else:
                outs[m] = y
    return outs


class GPipe(Module):
    """`n_stages` copies of `block` run as a pipeline.

    The module holds the copies (`stages`; the first is `block` itself,
    the others deep copies, so they start with its weights:
    `interop.load_gpipe_params` carries the reference's stacked tree into
    them, one slice of its leading stage axis each). `place_params(mesh)`
    puts stage s on position s of the mesh's "pipe" axis;
    `pipeline_apply` runs the fill-drain schedule there. The microbatch
    count defaults to the stage count.

        >>> import torch, bigdl_tpu_torch.nn as nn
        >>> from bigdl_tpu_torch.parallel import GPipe, Mesh
        >>> pipe = GPipe(nn.Linear(4, 4, device="cpu"), n_stages=2,
        ...              n_micro=8)
        >>> round(pipe.bubble_fraction, 3)
        0.111
        >>> mesh = Mesh(["cpu", "cpu"], ("pipe",))
        >>> x = torch.ones(16, 4)
        >>> out = pipe.pipeline_apply(mesh, x)
        >>> bool(torch.allclose(out, pipe(x)))
        True
    """

    def __init__(self, block: nn.Module, n_stages: int,
                 n_micro: Optional[int] = None, name=None):
        super().__init__(name)
        self.stages = nn.ModuleList(
            [block] + [copy.deepcopy(block) for _ in range(n_stages - 1)])
        self.n_stages = n_stages
        self.n_micro = n_micro or n_stages

    @property
    def block(self) -> nn.Module:
        return self.stages[0]

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the GPipe fill/drain schedule:
        (S-1)/(n_micro+S-1). Raise n_micro to amortize: 4 stages, 4
        micro -> 43%; 4 stages, 16 micro -> 16%."""
        return (self.n_stages - 1) / (self.n_micro + self.n_stages - 1)

    def place_params(self, mesh) -> "GPipe":
        """Put stage s on position s of the mesh's "pipe" axis."""
        for st, dev in zip(self.stages, _pipe_devices(mesh, self.n_stages)):
            st.to(dev)
        return self

    def forward(self, x):
        """The sequential reference: every stage in turn, each on its own
        device."""
        for st in self.stages:
            x = st(x.to(model_device(st) or x.device))
        return x

    def pipeline_apply(self, mesh, x, training: bool = False):
        """Run the GPipe schedule over the mesh's "pipe" axis. `x` [B, ...]
        with B divisible by `n_micro`; returns the sequential forward's
        result on x's device, each stage computed on its own device (idle
        fill and drain ticks are skipped: S x n_micro stage applies).
        Running statistics and modes are left as found."""
        n_micro, n_stages = self.n_micro, self.n_stages
        devs = _pipe_devices(mesh, n_stages)
        x = _as_tensor(x)
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        self.place_params(mesh)
        with run_scope(self.stages, training):
            outs = _fill_drain(self.stages, devs, x.split(b // n_micro))
        return torch.cat([o.to(x.device) for o in outs])


def _schedule_1f1b(S: int, M: int):
    """Static 1F1B action table: rows[t][s] = (op, micro) with op in
    {'I', 'F', 'B'}.

    Dependency-driven simulation of the classic non-interleaved 1F1B
    policy (PipeDream-Flush): stage s runs min(S - s, M) warmup forwards,
    then strictly alternates backward/forward until drained. Computed
    host-side once per (S, M); the traced loop just follows the table, so
    the schedule costs nothing on device."""
    warm = [min(S - s, M) for s in range(S)]
    next_f, next_b = [0] * S, [0] * S
    fwd_ready = [set(range(M))] + [set() for _ in range(S - 1)]
    bwd_ready = [set() for _ in range(S)]
    rows, done = [], 0
    while done < S * M:
        row = []
        for s in range(S):
            can_b = next_b[s] < M and next_b[s] in bwd_ready[s]
            # the 1F1B memory bound: a stage never runs more than its
            # warmup depth of forwards ahead of its backwards — it IDLES
            # instead (that idling is the pipeline bubble), keeping the
            # stash ≤ warm[s] ≤ S microbatches
            can_f = next_f[s] < M and next_f[s] in fwd_ready[s] \
                and next_f[s] - next_b[s] < warm[s]
            if can_b:
                row.append(("B", next_b[s]))
                next_b[s] += 1
            elif can_f:
                row.append(("F", next_f[s]))
                next_f[s] += 1
            else:
                row.append(("I", 0))
        for s, (op, m) in enumerate(row):   # effects land next tick
            if op == "F":
                (fwd_ready[s + 1] if s + 1 < S else bwd_ready[s]).add(m)
            elif op == "B":
                done += 1
                if s > 0:
                    bwd_ready[s - 1].add(m)
        rows.append(row)
        if len(rows) > 4 * (S + M) + 8:   # safety: schedule must drain
            raise RuntimeError("1F1B schedule failed to drain")
    return rows


class Boundary(NamedTuple):
    """The shape and dtype of one activation between stages (one
    microbatch's)."""
    shape: tuple
    dtype: torch.dtype


def _meta_twin(module: nn.Module) -> nn.Module:
    """A copy of `module` on the meta device, made without copying its
    tensors' data."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = nn.Parameter(torch.empty_like(p, device="meta"),
                                   requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def _boundary_shapes(stages, example: torch.Tensor) -> List[Boundary]:
    """Each stage's input and the last one's output for one microbatch,
    from a forward of meta twins in eval mode: no data and no launch. The
    fused BN tails run unfused (the same shapes); a kernel wrapper that
    has no meta route outside a FLOP count (the stem, attention) makes the
    forward run again inside one, where the wrappers only count."""
    from bigdl_tpu_torch.nn.fusion import fusion_scope
    twins = [_meta_twin(st).eval() for st in stages]

    def run():
        shapes = [Boundary(tuple(example.shape), example.dtype)]
        h = torch.empty(example.shape, dtype=example.dtype, device="meta")
        for twin in twins:
            h = twin(h)
            shapes.append(Boundary(tuple(h.shape), h.dtype))
        return shapes

    with torch.no_grad(), fusion_scope(False):
        try:
            return run()
        except NotImplementedError:
            out = []
            costs.count_flops(lambda: out.extend(run()))
            return out


class PipelineStages:
    """Heterogeneous pipeline: any per-stage modules, one stage a
    position of the mesh's "pipe" axis.

    `example_input`: one microbatch-shaped tensor (the global batch must
    split into `n_micro` microbatches of exactly this shape). Its
    activations fix `boundary_shapes` (S + 1 entries: each stage's input
    and the last output, found on the meta device) and `act_pad`, the
    largest boundary's element count (the reference's padded activation
    size; the port moves activations in their own shapes).

    Parameters live in the stage modules. `init()` gives them as the
    per-stage list of `{name: parameter}` (the reference's `init` returns
    the per-stage trees; `interop.load_pipeline_params` carries those in),
    `place_params(mesh)` puts stage s on position s of the "pipe" axis,
    and `ravel_stacked` / `unravel_stacked` convert such a list to the
    reference's padded [S, P_max] f32 layout (each stage's parameters in
    `named_parameters` order) and back.
    """

    def __init__(self, stages: Sequence[nn.Module], n_micro: int,
                 example_input, name: Optional[str] = None):
        if len(stages) < 2:
            raise ValueError("need at least 2 stages")
        self.stages = list(stages)
        self.S = len(self.stages)
        self.n_micro = n_micro
        self.name = name or "PipelineStages"
        self.boundary_shapes = _boundary_shapes(self.stages,
                                                _as_tensor(example_input))
        self.act_pad = max(math.prod(b.shape) for b in self.boundary_shapes)

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the 1F1B table for this (S, n_micro), counted
        from the actual schedule, not a formula."""
        rows = _schedule_1f1b(self.S, self.n_micro)
        idle = sum(1 for row in rows for op, _ in row if op == "I")
        return idle / (len(rows) * self.S)

    # -- params ---------------------------------------------------------
    def init(self) -> List[Dict[str, torch.Tensor]]:
        """The per-stage parameters, `{name: parameter}` a stage (the
        stages hold them; they were drawn when the stages were built)."""
        return [dict(st.named_parameters()) for st in self.stages]

    def _check_dtypes(self):
        """The reference's refusal: the pipelined paths take f32, bf16
        and f16 parameters only."""
        for s, st in enumerate(self.stages):
            for name, p in st.named_parameters():
                if p.dtype not in _PIPE_DTYPES:
                    raise TypeError(
                        f"PipelineStages params must be f32-compatible "
                        f"(f32/bf16/f16); got {name!r} of stage {s} with "
                        f"dtype {p.dtype}. Keep integer tensors out of "
                        f"the parameters or use the sequential apply() "
                        f"path.")

    def place_params(self, mesh) -> List[Dict[str, torch.Tensor]]:
        """Put stage s on position s of the mesh's "pipe" axis; returns
        `init()`'s list, placed. Refuses a parameter that is not f32,
        bf16 or f16 (`TypeError`), as the reference does."""
        devs = _pipe_devices(mesh, self.S)
        self._check_dtypes()
        for st, dev in zip(self.stages, devs):
            st.to(dev)
        return self.init()

    def ravel_stacked(self, params=None) -> torch.Tensor:
        """A per-stage list of `{name: tensor}` (default: the stages' own
        parameters) as one [S, P_max] f32 tensor: each stage's tensors
        flattened in `named_parameters` order and zero-padded to the
        largest stage, on the first stage's device."""
        params = self.init() if params is None else params
        self._check_dtypes()
        flats = [torch.cat([p.detach().reshape(-1).float()
                            for p in stage.values()]) if stage
                 else torch.zeros(0) for stage in params]
        dev = flats[0].device
        pmax = max(f.numel() for f in flats)
        return torch.stack([torch.nn.functional.pad(f.to(dev),
                                                    (0, pmax - f.numel()))
                            for f in flats])

    def unravel_stacked(self, stacked) -> List[Dict[str, torch.Tensor]]:
        """The inverse of `ravel_stacked`: [S, P_max] -> the per-stage list
        of `{name: tensor}` in each parameter's shape and dtype."""
        out = []
        for s, st in enumerate(self.stages):
            stage, off = {}, 0
            for name, p in st.named_parameters():
                n = p.numel()
                stage[name] = stacked[s, off:off + n].reshape(p.shape).to(
                    p.dtype)
                off += n
            out.append(stage)
        return out

    # -- sequential reference -------------------------------------------
    def apply(self, x):
        """Every stage in turn, each on its own device, in the stages'
        own modes."""
        h = _as_tensor(x)
        for st in self.stages:
            h = st(h.to(model_device(st) or h.device))
        return h

    forward = apply

    def _check_mesh(self, mesh):
        _pipe_devices(mesh, self.S)

    def _micro(self, x):
        """x split into the n_micro microbatches of the example's shape."""
        b, m = x.shape[0], self.n_micro
        if b % m:
            raise ValueError(f"batch {b} not divisible by n_micro {m}")
        mshape = tuple(self.boundary_shapes[0].shape)
        if tuple(x.shape[1:]) != mshape[1:] or b // m != mshape[0]:
            raise ValueError(
                f"microbatch shape {(b // m,) + tuple(x.shape[1:])} != "
                f"example shape {mshape}")
        return x.split(b // m)

    # -- pipelined forward (GPipe fill-drain) ---------------------------
    def pipeline_apply(self, mesh, x, training: bool = False):
        """Forward the full batch through the pipeline (GPipe's fill-drain
        order, idle ticks skipped); the result on x's device. Running
        statistics and modes are left as found."""
        self._check_mesh(mesh)
        x = _as_tensor(x)
        micro = self._micro(x)
        self.place_params(mesh)
        devs = _pipe_devices(mesh, self.S)
        with run_scope(self.stages, training):
            outs = _fill_drain(self.stages, devs, micro)
        return torch.cat([o.to(x.device) for o in outs])

    # -- 1F1B training step ---------------------------------------------
    def train_step_1f1b(self, mesh, x, y, loss_fn, training: bool = True):
        """One training step under the 1F1B schedule.

        `loss_fn(pred_micro, y_micro)` -> the scalar mean loss of one
        microbatch. Returns (the mean loss over microbatches, a 0-d f32
        tensor, and the per-stage gradients: a list of `{name: tensor}`
        matching `init()`, summed over microbatches in f32 in the order
        the stage's B ticks run, then cast to each parameter's dtype;
        `interop.pipeline_params_tree(pipe, grads)` gives the reference's
        per-stage gradient trees). A stage keeps at most its 1F1B
        in-flight depth (<= S) of stashed inputs."""
        n_stages, n_micro = self.S, self.n_micro
        self._check_mesh(mesh)
        x, y = _as_tensor(x), _as_tensor(y)
        micro_x = self._micro(x)
        micro_y = y.split(y.shape[0] // n_micro)
        self.place_params(mesh)
        devs = _pipe_devices(mesh, n_stages)
        names = [[n for n, _ in st.named_parameters()] for st in self.stages]
        params = [[p for _, p in st.named_parameters()]
                  for st in self.stages]
        acc = [[torch.zeros_like(p, dtype=torch.float32) for p in ps]
               for ps in params]
        stash = [dict() for _ in range(n_stages)]    # inputs by microbatch
        gstash = [dict() for _ in range(n_stages)]   # output gradients
        loss_sum = torch.zeros((), dtype=torch.float32, device=devs[-1])
        with run_scope(self.stages, training):
            for row in _schedule_1f1b(n_stages, n_micro):
                arrivals = []   # effects land next tick
                for s, (op, m) in enumerate(row):
                    if op == "I":
                        continue
                    stage = self.stages[s]
                    if s == 0:
                        x_in = micro_x[m].to(devs[0])
                    elif op == "F":
                        x_in = stash[s][m]
                    else:
                        x_in = stash[s].pop(m)
                    if op == "F":
                        with torch.no_grad():
                            out = stage(x_in)
                        if s + 1 < n_stages:
                            arrivals.append((stash[s + 1], m,
                                             out.to(devs[s + 1])))
                        continue
                    with torch.enable_grad():
                        want_gx = s > 0 and x_in.is_floating_point()
                        xi = x_in.detach().requires_grad_(want_gx)
                        out = stage(xi)
                        inputs = params[s] + ([xi] if want_gx else [])
                        if s == n_stages - 1:
                            loss_m = loss_fn(out, micro_y[m].to(devs[s]))
                            seed = torch.tensor(1.0 / n_micro,
                                                dtype=loss_m.dtype,
                                                device=loss_m.device)
                            grads = torch.autograd.grad(
                                loss_m, inputs, grad_outputs=seed,
                                allow_unused=True)
                            loss_sum += loss_m.detach().float()
                        else:
                            grads = torch.autograd.grad(
                                out, inputs, grad_outputs=gstash[s].pop(m),
                                allow_unused=True)
                    for a, g in zip(acc[s], grads[:len(params[s])]):
                        if g is not None:
                            a.add_(g)
                    if want_gx:
                        gx = grads[-1] if grads[-1] is not None \
                            else torch.zeros_like(xi)
                        arrivals.append((gstash[s - 1], m,
                                         gx.to(devs[s - 1])))
                for box, m, value in arrivals:
                    box[m] = value
        grads = [{n: a.to(p.dtype) for n, a, p in zip(ns, accs, ps)}
                 for ns, accs, ps in zip(names, acc, params)]
        return loss_sum / n_micro, grads


def split_sequential(model, n_stages: int,
                     boundaries: Optional[Sequence[int]] = None):
    """Split a `Sequential`'s children into `n_stages` contiguous stage
    `Sequential`s for `PipelineStages`, e.g. ResNet-50 at its natural
    stage boundaries. The stages hold the model's own child modules.

    `boundaries`: child indices where stages START (n_stages - 1 of them,
    strictly increasing); default: an even split by child count."""
    children = model.children_in_order()
    n = len(children)
    if n < n_stages:
        raise ValueError(f"{n} children cannot make {n_stages} stages")
    if boundaries is None:
        step = n / n_stages
        boundaries = [round(step * i) for i in range(1, n_stages)]
    cuts = [0] + list(boundaries) + [n]
    if sorted(set(cuts)) != cuts:
        raise ValueError(f"boundaries must be strictly increasing: {cuts}")
    stages = []
    for a, b in zip(cuts, cuts[1:]):
        st = Sequential(name=f"stage{len(stages)}")
        for child in children[a:b]:
            st.add(child)
        stages.append(st)
    return stages
