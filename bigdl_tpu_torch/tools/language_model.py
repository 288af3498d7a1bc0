"""Train the PTB LSTM language model on a synthetic corpus (counterpart of
`examples/languagemodel.py`).

`PTBModel(vocab + 1, hidden, vocab + 1)` (2 LSTM layers) learns the
seeded Markov corpus of `tools/transformer_lm.py` (`synthetic_ptb`: 20,000
tokens over 200 words, each word predicting ~3 successors 80% of the
time), cut into sequences of `--seq-len` 1-based ids (`batchify`, float
ids as the reference's example feeds them), through the `Optimizer`
factory: `Adam(2e-3)` on `TimeDistributedCriterion(ClassNLLCriterion())`
(the loss summed over the time steps), `--batch-size` 32, `--max-epoch`
2. It prints the perplexity on the first 64 training sequences (chance is
about the vocabulary size).

    python -m bigdl_tpu_torch.tools.language_model              # on the card
    python -m bigdl_tpu_torch.tools.language_model --device cpu

The reference's `--data-file` (a real `ptb.train.txt`) waits until such a
file is in the repository.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def batchify(tokens: np.ndarray, seq_len: int):
    """Inputs and next-token targets [n, seq_len] from a 0-based token
    stream, as 1-based float ids."""
    n = (len(tokens) - 1) // seq_len
    X = tokens[:n * seq_len].reshape(n, seq_len)
    Y = tokens[1:n * seq_len + 1].reshape(n, seq_len)
    return X.astype(np.float32) + 1, Y.astype(np.float32) + 1


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=20)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-epoch", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch._device import resolve_device
    from bigdl_tpu_torch.models import PTBModel
    from bigdl_tpu_torch.tools.transformer_lm import synthetic_ptb

    device = resolve_device(args.device)
    tokens, vocab = synthetic_ptb()
    X, Y = batchify(tokens, args.seq_len)
    model = PTBModel(input_size=vocab + 1, hidden_size=args.hidden,
                     output_size=vocab + 1, num_layers=2, device=device)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    opt = optim.Optimizer(model, (X, Y), crit, batch_size=args.batch_size,
                          local=True, device=device)
    opt.set_optim_method(optim.Adam(learning_rate=2e-3))
    opt.set_end_when(optim.max_epoch(args.max_epoch))
    trained = opt.optimize()

    # perplexity on the training head (the example's own metric)
    trained.eval()
    with torch.no_grad():
        logp = trained(torch.from_numpy(X[:64]).to(device))
        nll = -logp.gather(
            -1, torch.from_numpy(Y[:64] - 1).long().to(device)[..., None]
        ).mean()
    ppl = float(torch.exp(nll))
    print(f"Perplexity is {ppl}")
    return ppl


if __name__ == "__main__":
    main()
