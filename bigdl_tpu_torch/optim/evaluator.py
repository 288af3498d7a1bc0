"""Evaluation (counterpart of `bigdl_tpu/optim/evaluator.py`).

`Evaluator(model, batch_size).test(dataset, methods)` runs the model's
forward over the dataset's batches through a `LocalPredictor` (the
converted copy: BN folded) and reduces each `ValidationMethod` with `+`.
Each batch's statistics (`ValidationMethod.stats`) are summed on the
device and the results are read with one host fetch after the last batch.
A method without a stats path (a user subclass that overrides only
`apply`) falls back to per-batch host `apply`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from bigdl_tpu_torch.optim.predictor import LocalPredictor
from bigdl_tpu_torch.optim.validation import ValidationMethod, ValidationResult


def _prefers_device_stats(method: ValidationMethod) -> bool:
    """True when `method`'s `stats` is defined at or below its most-derived
    `apply`: a subclass that overrides only `apply` must take the host
    path, or its inherited `stats` would compute something else."""
    for cls in type(method).__mro__:
        if "stats" in cls.__dict__:
            return True
        if "apply" in cls.__dict__:
            return False
    return False


class Evaluator:
    """`model.evaluate` (reference `Evaluator`): `predictor`, if given, is
    a `LocalPredictor` of the model to reuse; else one is built on `device`
    (default CUDA)."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 predictor: LocalPredictor = None, *, device=None):
        self.model = model
        self.batch_size = batch_size
        self._pred = predictor or LocalPredictor(model, batch_size,
                                                 device=device)

    def test(self, dataset, methods: Sequence[ValidationMethod]
             ) -> List[ValidationResult]:
        """One result per method over every batch of `dataset` (an array,
        an `AbstractDataSet`, or an iterable of Samples or MiniBatches)."""
        pred = self._pred
        accs = [None] * len(methods)
        host: List[ValidationResult] = [None] * len(methods)
        use_stats = [_prefers_device_stats(m) for m in methods]
        for batch in pred._batches(dataset):
            out = pred._forward(pred._to_device(batch.get_input()))
            t = batch.get_target()
            t = None if t is None else pred._to_device(t)
            with torch.inference_mode():
                for i, m in enumerate(methods):
                    s = m.stats(out, t) if use_stats[i] else None
                    if s is None:
                        r = m.apply(out, t)
                        host[i] = r if host[i] is None else host[i] + r
                    else:
                        accs[i] = s if accs[i] is None else accs[i] + s
        summed = [a for a in accs if a is not None]
        fetched = torch.stack(summed).cpu().tolist() if summed else []
        results: List[ValidationResult] = []
        for i, m in enumerate(methods):
            r = m.from_stats(fetched.pop(0)) if accs[i] is not None \
                else None
            if host[i] is not None:
                r = host[i] if r is None else r + host[i]
            results.append(r)
        return results


# the reference's validator classes
LocalValidator = Evaluator
DistriValidator = Evaluator
