"""Int8 quantized inference (counterpart of
`examples/quantized_inference.py`, the reference's int8 inference story:
up to 2x inference speed and 4x model size at <0.1% accuracy drop,
through `Module.quantize()`).

A VGG-style classifier (two 3x3 convolutions with max pools, two
`Linear`s) trains on `--n` synthetic 32x32x3 images of 3 classes (seed 5;
a class brightens its own channel) with `Optimizer` and `Adam(3e-3)` at
batch 32 for `--max-epoch` epochs; `Quantizer.quantize` then makes its
full-int8 twin. It prints the f32 and int8 accuracies on the training
images, their top-1 agreement and the size ratio, and requires an
agreement above 0.95 and a ratio above 2.5, as the reference does.

The size ratio compares the two models' `ModuleSerializer` files, as the
reference's does (the int8 weights stored as int8, the file's module tree
and scales beside them).

    python -m bigdl_tpu_torch.tools.quantized_inference              # card
    python -m bigdl_tpu_torch.tools.quantized_inference --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

import numpy as np
import torch


def build_model(n_class: int, device=None):
    """The example's mini-VGG, [B, 32, 32, 3] -> [B, n_class]
    log-probabilities, its weights drawn from one generator (seed 0)."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.models._builder import Builder
    kw = Builder(device).kw
    return (nn.Sequential(name="mini_vgg")
            .add(nn.SpatialConvolution(3, 16, 3, 3, pad_w=1, pad_h=1, **kw))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2))
            .add(nn.SpatialConvolution(16, 32, 3, 3, pad_w=1, pad_h=1, **kw))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2))
            .add(nn.Reshape((32 * 8 * 8,)))
            .add(nn.Linear(32 * 8 * 8, 64, **kw))
            .add(nn.ReLU())
            .add(nn.Linear(64, n_class, **kw))
            .add(nn.LogSoftMax()))


def _model_file_bytes(root: str, tag: str, model) -> int:
    from bigdl_tpu_torch.serialization import ModuleSerializer
    path = os.path.join(root, f"{tag}.bigdl")
    ModuleSerializer.save(model, path)
    return os.path.getsize(path)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=240)
    p.add_argument("--max-epoch", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch._device import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Quantizer
    from bigdl_tpu_torch.optim import Adam, Optimizer, max_epoch
    device = resolve_device(args.device)

    rs = np.random.RandomState(5)
    n_class = 3
    y = (rs.randint(0, n_class, size=args.n) + 1).astype(np.int32)
    x = rs.rand(args.n, 32, 32, 3).astype(np.float32) * 0.3
    for i in range(args.n):
        x[i, :, :, y[i] - 1] += 0.6

    model = build_model(n_class, device)
    opt = Optimizer(model, (x, y), ClassNLLCriterion(), batch_size=32,
                    local=True, device=device)
    opt.set_optim_method(Adam(learning_rate=3e-3))
    opt.set_end_when(max_epoch(args.max_epoch))
    opt.optimize()

    xt = torch.from_numpy(x).to(device)
    qmodel = Quantizer.quantize(model.eval())
    with torch.inference_mode():
        f32_top = model(xt).argmax(1).cpu().numpy()
        q_top = qmodel(xt).argmax(1).cpu().numpy()
    res = {"fp32_acc": float(((f32_top + 1) == y).mean()),
           "int8_acc": float(((q_top + 1) == y).mean()),
           "top1_agreement": float((q_top == f32_top).mean())}
    with tempfile.TemporaryDirectory() as d:
        res["size_ratio"] = (_model_file_bytes(d, "fp32", model)
                             / _model_file_bytes(d, "int8", qmodel))
    print(f"fp32 acc={res['fp32_acc']:.3f}  int8 acc={res['int8_acc']:.3f}  "
          f"top-1 agreement={res['top1_agreement']:.3f}  size ratio "
          f"fp32/int8={res['size_ratio']:.2f}x")
    if res["top1_agreement"] <= 0.95 or res["size_ratio"] <= 2.5:
        raise SystemExit(f"int8 model off the reference's bounds: {res}")
    return res


if __name__ == "__main__":
    main()
