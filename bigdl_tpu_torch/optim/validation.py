"""Validation methods and results (counterpart of
`bigdl_tpu/optim/validation.py`).

Top1Accuracy, Top5Accuracy, Loss, MAE, HitRatio, NDCG and TreeNNAccuracy;
results merge with `+`. Each method's `stats(output, target)` returns a
small f32 tensor [numerator, count] on the output's device without a host
sync, so `Evaluator.test` sums them on the device and reads the host once
at the end; `from_stats` builds the result from the summed pair, and
`apply` is the two together.
"""

from __future__ import annotations

import torch


class ValidationResult:
    """A mergeable result."""

    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    """A (correct, count) pair; `result()` is (accuracy, count)."""

    def __init__(self, correct: float, count: float):
        self.correct, self.count = float(correct), float(count)

    def result(self):
        return (self.correct / max(self.count, 1.0), int(self.count))

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, n = self.result()
        return (f"Accuracy(correct={int(self.correct)}, count={n}, "
                f"accuracy={acc})")


class LossResult(ValidationResult):
    """A (summed loss, count) pair; `result()` is (mean loss, count)."""

    def __init__(self, loss: float, count: float):
        self.loss, self.count = float(loss), float(count)

    def result(self):
        return (self.loss / max(self.count, 1.0), int(self.count))

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        avg, n = self.result()
        return f"Loss(loss={self.loss}, count={n}, average={avg})"


class ContiguousResult(LossResult):
    """A scalar sum with its count."""


class ValidationMethod:
    """`apply(output, target)` -> the `ValidationResult` of one batch.

    The device protocol: `stats` returns the [numerator, count] f32 tensor
    of a batch (None, the base's default, sends the caller to per-batch
    `apply`), and `from_stats` builds the result from a summed pair."""

    def apply(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __call__(self, output, target):
        return self.apply(output, target)

    def stats(self, output, target):
        return None

    def from_stats(self, stats) -> ValidationResult:
        raise NotImplementedError(
            f"{type(self).__name__} has no device-stats path")


class _StatsMethod(ValidationMethod):
    """A built-in method: `apply` is `from_stats(stats(...))`, the result
    an `AccuracyResult` unless the method says otherwise."""

    def from_stats(self, stats):
        s = stats.tolist() if isinstance(stats, torch.Tensor) else stats
        return AccuracyResult(float(s[0]), float(s[1]))

    def apply(self, output, target):
        return self.from_stats(self.stats(output, target))


def _loss_result(stats):
    s = stats.tolist() if isinstance(stats, torch.Tensor) else stats
    return LossResult(float(s[0]), float(s[1]))


def _pair(num, n):
    """[num, n] as an f32 tensor on num's device; the count is filled on
    the device, so nothing waits for the host."""
    num = num.float()
    return torch.stack([num, num.new_full((), float(n))])


class Top1Accuracy(_StatsMethod):
    """The argmax against 1-based class targets (0-based with
    `zero_based`). A single sigmoid unit ([N, 1] output) is thresholded at
    0.5 against the raw 0/1 target, and one-hot (or probability) targets
    of the output's shape are compared by their argmax, as in the
    reference."""

    def __init__(self, zero_based: bool = False):
        self.zero_based = zero_based

    def stats(self, output, target):
        out = torch.as_tensor(output)
        t = torch.as_tensor(target, device=out.device)
        if out.dim() >= 1 and out.shape[-1] == 1:
            pred = (out.reshape(-1) >= 0.5).int()
            t = t.int().reshape(-1)
            return _pair((pred == t).sum(), t.shape[0])
        pred = out.argmax(-1)
        if t.dim() == out.dim() and t.shape[-1] > 1:
            t = t.argmax(-1).reshape(-1)
        else:
            t = t.long().reshape(-1)
            if not self.zero_based:
                t = t - 1
        return _pair((pred.reshape(-1) == t).sum(), t.shape[0])

    def __repr__(self):
        return "Top1Accuracy"


class Top5Accuracy(_StatsMethod):
    """The target among the five highest scores (1-based targets unless
    `zero_based`)."""

    def __init__(self, zero_based: bool = False):
        self.zero_based = zero_based

    def stats(self, output, target):
        out = torch.as_tensor(output)
        t = torch.as_tensor(target, device=out.device).long().reshape(-1)
        if not self.zero_based:
            t = t - 1
        o = out.reshape(t.shape[0], -1)
        top5 = o.topk(min(5, o.shape[-1]), dim=-1).indices
        hit = (top5 == t[:, None]).any(-1)
        return _pair(hit.sum(), t.shape[0])

    def __repr__(self):
        return "Top5Accuracy"


class Loss(_StatsMethod):
    """The criterion's mean loss over the rows (default
    `ClassNLLCriterion()`), weighted by each batch's rows."""

    def __init__(self, criterion=None):
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def stats(self, output, target):
        loss = self.criterion(output, target)
        n = output.shape[0] if hasattr(output, "shape") else 1
        return _pair(loss.float() * n, n)

    def from_stats(self, stats):
        return _loss_result(stats)

    def __repr__(self):
        return "Loss"


class MAE(_StatsMethod):
    """Mean absolute error between the 1-based argmax and the target, as
    the reference computes it."""

    def stats(self, output, target):
        out = torch.as_tensor(output)
        pred = out.argmax(-1).float() + 1.0
        t = torch.as_tensor(target, device=out.device).float().reshape(-1)
        n = out.shape[0]
        return _pair((pred - t).abs().mean() * n, n)

    def from_stats(self, stats):
        return _loss_result(stats)

    def __repr__(self):
        return "MAE"


def _positive_rank(output, target, neg_num):
    """The 1-based rank of the positive item of each group of `neg_num +
    1` scores; the positive is where the target is 1 (column 0 without a
    target)."""
    o = torch.as_tensor(output).reshape(-1, neg_num + 1)
    if target is None:
        pos = o[:, 0]
    else:
        t = torch.as_tensor(target, device=o.device).reshape(o.shape)
        pos = (o * (t == 1)).sum(-1)
    return o, (o > pos[:, None]).int().sum(-1) + 1


class HitRatio(_StatsMethod):
    """HR@k: the share of groups (1 positive and `neg_num` negatives)
    whose positive ranks within the top k."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k, self.neg_num = k, neg_num

    def stats(self, output, target):
        o, rank = _positive_rank(output, target, self.neg_num)
        return _pair((rank <= self.k).sum(), o.shape[0])

    def __repr__(self):
        return f"HitRate@{self.k}"


class NDCG(_StatsMethod):
    """NDCG@k of the positive's rank in each group."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k, self.neg_num = k, neg_num

    def stats(self, output, target):
        o, rank = _positive_rank(output, target, self.neg_num)
        gain = torch.where(rank <= self.k,
                           1.0 / torch.log2(rank.float() + 1.0),
                           torch.zeros((), device=o.device))
        return _pair(gain.sum(), o.shape[0])

    def __repr__(self):
        return f"NDCG@{self.k}"


class TreeNNAccuracy(_StatsMethod):
    """Accuracy of the root prediction of a tree output [B, N, C] (the
    first node's scores) against 1-based targets (the first column of a
    2-D target)."""

    def stats(self, output, target):
        out = torch.as_tensor(output)
        o = out[:, 0, :] if out.dim() == 3 else out
        t = torch.as_tensor(target, device=out.device)
        t = t[:, 0] if t.dim() >= 2 else t
        pred = o.argmax(-1)
        return _pair((pred == t.long() - 1).sum(), o.shape[0])

    def __repr__(self):
        return "TreeNNAccuracy"
