"""Train Wide&Deep on a synthetic recommendation task (counterpart of
`examples/wide_n_deep.py`, `BASELINE.md` config 5's example).

`synthetic_recs` draws 2,048 records (6 wide ids a record over 200
features, 3 categorical columns of 50, 30 and 20 values, 4 continuous
features; seed 0) whose click label follows a few "hot" wide features,
the parity of the first categorical column and the first continuous
feature. `WideAndDeep(2, 200, (50, 30, 20), cont_dim=4)` of
`--model-type` (`wide_n_deep`, `wide` or `deep`) trains on it with the
reference example's own loop: `Adam(5e-3)` on `ClassNLLCriterion`,
`--batch-size` 128, `--max-epoch` 6, each epoch's order from
`np.random.RandomState(epoch)`, the last partial batch dropped. It prints
each epoch's mean loss and the train accuracy.

    python -m bigdl_tpu_torch.tools.wide_n_deep                # on the card
    python -m bigdl_tpu_torch.tools.wide_n_deep --device cpu
    python -m bigdl_tpu_torch.tools.wide_n_deep --model-type deep

`--data-dir` takes a MovieLens directory (`ratings.dat` or
`ratings.csv`, read by `dataset/movielens.py`) in place of the synthetic
records, as in the reference; no such file is in the repository.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def synthetic_recs(n: int = 2048, wide_dim: int = 200,
                   vocabs: Sequence[int] = (50, 30, 20), cont_dim: int = 4,
                   seed: int = 0):
    """Clicks driven by a sparse wide signal and a categorical pattern:
    ((wide ids, wide values, categorical ids, continuous), labels), the
    ids as float 1-based values and the labels 1 or 2 (int32), as the
    reference example draws them."""
    rng = np.random.RandomState(seed)
    Lw = 6
    wide_idx = rng.randint(1, wide_dim + 1, (n, Lw)).astype(np.float32)
    wide_val = np.ones((n, Lw), np.float32)
    cat = np.stack([rng.randint(1, v + 1, n) for v in vocabs], 1).astype(
        np.float32)
    cont = rng.randn(n, cont_dim).astype(np.float32)
    # ground truth: a few "hot" wide features + one categorical pattern
    hot = set(rng.randint(1, wide_dim + 1, 12).tolist())
    score = np.asarray([sum(int(i) in hot for i in row)
                        for row in wide_idx], np.float32)
    score = score + (cat[:, 0] % 2) + 0.5 * cont[:, 0]
    labels = (score > np.median(score)).astype(np.int32) + 1  # 1-based
    return (wide_idx, wide_val, cat, cont), labels


def movielens_recs(data_dir: str, cont_dim: int = 4):
    """The reference example's MovieLens features: the item as the wide
    id, (user, item, rating % 7 + 1) as the categorical columns, zero
    continuous features, label 2 for a rating of 4 or more. Returns
    (data, labels, wide_dim, vocabs)."""
    from bigdl_tpu_torch.dataset import movielens
    triples = movielens.read_data_sets(data_dir)
    n = len(triples)
    users = triples[:, 0].astype(np.float32)
    items = triples[:, 1].astype(np.float32)
    wide_dim = int(items.max()) + 1
    vocabs = (int(users.max()) + 1, int(items.max()) + 1, 7)
    wide_idx = items[:, None]
    cat = np.stack([users, items,
                    (triples[:, 2] % 7 + 1).astype(np.float32)], 1)
    data = (wide_idx, np.ones_like(wide_idx), cat,
            np.zeros((n, cont_dim), np.float32))
    labels = (triples[:, 2] >= 4).astype(np.int32) + 1
    return data, labels, wide_dim, vocabs


def train(model: torch.nn.Module, data: Sequence[np.ndarray],
          labels: np.ndarray, batch_size: int = 128, max_epoch: int = 6,
          learning_rate: float = 5e-3,
          log: Optional[Callable[[str], None]] = print
          ) -> Tuple[List[float], float]:
    """The example's loop on `model` (on its device): each epoch the
    records in `RandomState(epoch)` order, full batches of `batch_size`,
    one Adam step each on the batch's mean NLL. Returns each epoch's mean
    loss and the train accuracy (the model in eval mode over every
    record)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.utils import T

    device = next(model.parameters()).device
    cols = [torch.from_numpy(np.ascontiguousarray(d)).to(device)
            for d in data]
    y_all = torch.from_numpy(labels).to(device)
    crit = ClassNLLCriterion()
    method = Adam(learning_rate=learning_rate)
    params = dict(model.named_parameters())
    opt_state = method.init_state(params)
    lr = method.current_lr()
    n = len(labels)
    epoch_losses = []
    model.train()
    for epoch in range(max_epoch):
        perm = torch.from_numpy(
            np.random.RandomState(epoch).permutation(n)).to(device)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            sel = perm[i:i + batch_size]
            loss = crit(model(T(*[c[sel] for c in cols])), y_all[sel])
            # the half a model type leaves out gets zeros, as in jax.grad
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            method.update(dict(zip(params, grads)), opt_state, params, lr)
            losses.append(loss.detach())
        epoch_losses.append(float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64))))
        if log:
            log(f"[Epoch {epoch + 1}] loss {epoch_losses[-1]:.4f}")
    model.eval()
    with torch.no_grad():
        out = model(T(*cols))
    pred = out.argmax(1).cpu().numpy() + 1
    return epoch_losses, float((pred == labels).mean())


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--model-type", default="wide_n_deep",
                   choices=["wide", "deep", "wide_n_deep"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-epoch", type=int, default=6)
    p.add_argument("--data-dir", default=None,
                   help="MovieLens dir (ratings.dat/csv) for real data")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch._device import resolve_device
    from bigdl_tpu_torch.models import WideAndDeep

    device = resolve_device(args.device)
    wide_dim, vocabs, cont_dim = 200, (50, 30, 20), 4
    if args.data_dir:
        data, labels, wide_dim, vocabs = movielens_recs(args.data_dir,
                                                        cont_dim)
    else:
        data, labels = synthetic_recs(wide_dim=wide_dim, vocabs=vocabs,
                                      cont_dim=cont_dim)
    model = WideAndDeep(class_num=2, wide_dim=wide_dim, embed_vocabs=vocabs,
                        cont_dim=cont_dim, model_type=args.model_type,
                        device=device)
    _, acc = train(model, data, labels, args.batch_size, args.max_epoch)
    print(f"Train accuracy ({args.model_type}): {acc}")
    return acc


if __name__ == "__main__":
    main()
