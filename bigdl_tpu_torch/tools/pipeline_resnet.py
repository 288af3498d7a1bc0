"""Pipeline-parallel training with heterogeneous stages and 1F1B
(counterpart of `examples/pipeline_resnet.py`).

A small CNN split into heterogeneous stages (`PipelineStages`), one stage
a position of a "pipe" mesh, trains through the 1F1B schedule
(`train_step_1f1b`); before training, its first step's loss and gradients
are checked against sequential autodiff of the whole batch. `--model
resnet50` instead pipelines the zoo's ResNet-50 forward (split with
`split_sequential` at its natural stage boundaries) and checks it against
the sequential forward.

    python -m bigdl_tpu_torch.tools.pipeline_resnet              # on the card
    python -m bigdl_tpu_torch.tools.pipeline_resnet --device cpu
    python -m bigdl_tpu_torch.tools.pipeline_resnet --model resnet50

The mesh holds every card when there are `--stages` or more, else the one
device `--stages` times (a stage a position: the schedule is the same,
and activations move between positions on one device for free).

`microbatch_oracle` is the 1F1B step's function written as a plain loop,
which the checks of a model with BN (each microbatch normalized by its
own statistics) hold `train_step_1f1b` to.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device


def microbatch_oracle(pipe, x, y, loss_fn, training: bool = True):
    """The function of `pipe.train_step_1f1b(mesh, x, y, loss_fn)` as a
    plain loop: each of the M microbatches through the stages' sequential
    forward and one backward over the whole model (loss / M), the
    parameter gradients summed in f32 in microbatch order; running
    statistics and modes left as found. Returns (the mean loss, the
    per-stage `{name: gradient}` list)."""
    from bigdl_tpu_torch.parallel.pipeline import run_scope
    n_micro = pipe.n_micro
    named = [list(st.named_parameters()) for st in pipe.stages]
    flat = [p for stage in named for _, p in stage]
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
    loss_sum = None
    with run_scope(pipe.stages, training):
        for xm, ym in zip(x.split(x.shape[0] // n_micro),
                          y.split(y.shape[0] // n_micro)):
            with torch.enable_grad():
                out = pipe.apply(xm)
                loss_m = loss_fn(out, ym.to(out.device))
                grads = torch.autograd.grad(loss_m / n_micro, flat,
                                            allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
            loss_m = loss_m.detach().float()
            loss_sum = loss_m if loss_sum is None else loss_sum + loss_m
    out, i = [], 0
    for stage in named:
        out.append({n: acc[i + k].to(p.dtype)
                    for k, (n, p) in enumerate(stage)})
        i += len(stage)
    return loss_sum / n_micro, out


def pipe_mesh(n_stages: int, device):
    """A "pipe" mesh of every card when there are `n_stages` or more,
    else `device` `n_stages` times."""
    from bigdl_tpu_torch.parallel import Mesh
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_stages:
        return Mesh([torch.device("cuda", i) for i in range(n_stages)],
                    ("pipe",))
    return Mesh([dev] * n_stages, ("pipe",))


def _cnn_stages(n_stages: int, device):
    import bigdl_tpu_torch.nn as nn
    g = torch.Generator().manual_seed(1)
    kw = {"device": device, "generator": g}
    return [
        nn.Sequential().add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1,
                                                  **kw)).add(nn.ReLU()),
        nn.Sequential().add(nn.SpatialConvolution(8, 16, 3, 3, 2, 2, 1, 1,
                                                  **kw)).add(nn.ReLU()),
        nn.Sequential().add(nn.Pooler()).add(nn.Linear(16, 32, **kw))
                       .add(nn.Tanh()),
        nn.Linear(32, 10, **kw),
    ][:n_stages]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stages", type=int, default=4)
    p.add_argument("--micro", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--model", choices=["cnn", "resnet50"], default="cnn")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (cpu: the CPU)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.parallel import PipelineStages, split_sequential
    device = resolve_device(args.device)
    n_stages = args.stages
    mesh = pipe_mesh(n_stages, device)
    rs = np.random.RandomState(0)
    micro_b = max(1, args.batch_size // args.micro)

    if args.model == "resnet50":
        from bigdl_tpu_torch.models import ResNet
        model = ResNet(class_num=10, depth=50, device=device)
        stages = split_sequential(model, n_stages)
        pipe = PipelineStages(stages, args.micro,
                              torch.zeros(micro_b, 32, 32, 3, device=device))
        x = torch.from_numpy(rs.rand(micro_b * args.micro, 32, 32, 3)
                             .astype(np.float32)).to(device)
        with torch.no_grad():
            model.eval()
            seq = pipe.apply(x)
            out = pipe.pipeline_apply(mesh, x)
        err = float((out - seq).abs().max())
        print(f"ResNet-50 over {n_stages} pipeline stages: out "
              f"{tuple(out.shape)}, max |pipe - seq| = {err:.2e}")
        assert err < 2e-3
        return err

    stages = _cnn_stages(n_stages, device)
    pipe = PipelineStages(stages, args.micro,
                          torch.zeros(micro_b, 16, 16, 3, device=device))
    print(f"{n_stages} hetero stages, n_micro={args.micro}, "
          f"1F1B bubble fraction {pipe.bubble_fraction:.1%}")
    b = micro_b * args.micro
    labels = rs.randint(0, 10, size=b)
    x = torch.from_numpy((rs.rand(b, 16, 16, 3) + labels[:, None, None, None]
                          * 0.05).astype(np.float32)).to(device)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[labels]).to(device)

    def loss_fn(pred, yy):
        return -torch.mean(torch.sum(torch.log_softmax(pred, -1) * yy, -1))

    # one check against sequential autodiff of the whole batch first
    loss_pp, grads_pp = pipe.train_step_1f1b(mesh, x, y, loss_fn)
    params = [p for st in pipe.stages for p in st.parameters()]
    loss_ref = loss_fn(pipe.apply(x), y)
    grads_ref = torch.autograd.grad(loss_ref, params)
    loss_ref = loss_ref.detach()
    got = [g for stage in grads_pp for g in stage.values()]
    assert abs(float(loss_pp) - float(loss_ref)) < 1e-5
    for a, r in zip(got, grads_ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
    print(f"1F1B step loss {float(loss_pp):.4f} == sequential "
          f"{float(loss_ref):.4f}")

    losses = []
    for step in range(args.steps):
        loss, grads = pipe.train_step_1f1b(mesh, x, y, loss_fn)
        with torch.no_grad():
            for st, g in zip(pipe.stages, grads):
                for name, param in st.named_parameters():
                    param -= args.lr * g[name]
        losses.append(float(loss))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[step {step}] loss {losses[-1]:.4f}")
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    print(f"pipeline training converges: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
