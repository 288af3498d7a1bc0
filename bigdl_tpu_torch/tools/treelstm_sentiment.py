"""TreeLSTM sentiment classification (counterpart of
`examples/treelstm_sentiment.py`).

The reference's synthetic corpus and trees: `--sentences` sentences of
`--tokens` words embedded in `--embed-dim` dimensions (N(0, 0.25) from
`RandomState(0)`), labelled by the sign of the sum of each word's first
coordinate, parsed as right-branching binary trees (leaves first, then
each internal node joining leaf i with the subtree to its right; the
root last). `BinaryTreeLSTM(embed_dim, hidden)` reads the trees, the
root's state goes through `Linear(hidden, 2)` and `LogSoftMax`, and
`Adam(5e-3)` minimises `ClassNLLCriterion` over the whole corpus as one
batch for `--max-iteration` steps. It prints the final loss and the
training accuracy.

    python -m bigdl_tpu_torch.tools.treelstm_sentiment   # on the card
    python -m bigdl_tpu_torch.tools.treelstm_sentiment --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def make_corpus(n: int, n_tokens: int, dim: int, seed: int = 0):
    """Sentences [n, n_tokens, dim] and 1-based labels: 2 where the sum of
    the words' first coordinates is positive, else 1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n_tokens, dim).astype(np.float32) * 0.5
    y = (x[:, :, 0].sum(axis=1) > 0).astype(np.int32) + 1
    return x, y


def right_branching_tree(n_tokens: int) -> np.ndarray:
    """The tree's rows [left, right, leaf] (1-based): the leaves, then
    the internal nodes joining leaf i with the subtree to its right."""
    rows = [[0, 0, i + 1] for i in range(n_tokens)]
    prev = n_tokens  # the 1-based row of the rightmost leaf
    for i in range(n_tokens - 1, 0, -1):
        rows.append([i, prev, 0])
        prev = len(rows)
    return np.asarray(rows, np.int32)


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--sentences", type=int, default=256)
    p.add_argument("--tokens", type=int, default=6)
    p.add_argument("--embed-dim", type=int, default=8)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--max-iteration", type=int, default=120)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch._device import resolve_device
    from bigdl_tpu_torch.utils import T

    device = resolve_device(args.device)
    x, y = make_corpus(args.sentences, args.tokens, args.embed_dim)
    tree = right_branching_tree(args.tokens)
    trees = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        tree, (args.sentences,) + tree.shape))).to(device)
    root = tree.shape[0]  # the root is the last row
    xs = torch.from_numpy(x).to(device)
    ys = torch.from_numpy(y).to(device)

    g = torch.Generator().manual_seed(0)
    tl = nn.BinaryTreeLSTM(args.embed_dim, args.hidden, device=device,
                           generator=g)
    head = nn.Sequential().add(nn.Linear(args.hidden, 2, device=device,
                                         generator=g)).add(nn.LogSoftMax())
    crit = nn.ClassNLLCriterion()
    params = {f"tree.{k}": v for k, v in tl.named_parameters()}
    params.update({f"head.{k}": v for k, v in head.named_parameters()})
    method = optim.Adam(learning_rate=5e-3)
    opt_state = method.init_state(params)

    def logits():
        return head(tl(T(xs, trees))[:, root - 1])

    loss = None
    for _ in range(args.max_iteration):
        loss = crit(logits(), ys)
        grads = torch.autograd.grad(loss, list(params.values()))
        method.update(dict(zip(params, grads)), opt_state, params, 5e-3)
    with torch.no_grad():
        pred = logits().argmax(1) + 1
    acc = float((pred == ys).float().mean())
    print(f"final loss {float(loss.detach()):.4f}, train accuracy {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
