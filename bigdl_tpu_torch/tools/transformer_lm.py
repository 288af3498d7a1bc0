"""Train the TransformerLM on a synthetic corpus (counterpart of
`examples/transformer_lm.py`).

A decoder-only `TransformerLM` (RoPE, pre-norm, flash attention: the
forward kernel and the two backward kernels on the card) learns a
synthetic Markov corpus with strong bigram structure through the
`Optimizer` factory: `AdamW(3e-3, weight decay 0.01)` with a linear
warm-up into a cosine tail (`WarmupCosineDecay`) on
`TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)`. It
prints the perplexity on training shards (chance is about the vocabulary
size) and then scores a sequence longer than the training length (RoPE is
length-free, so the same weights extend).

    python -m bigdl_tpu_torch.tools.transformer_lm              # on the card
    python -m bigdl_tpu_torch.tools.transformer_lm --device cpu

`--sequence-parallel` (ring, Ulysses, zigzag attention over several
devices) is not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def synthetic_ptb(n_tokens: int = 20000, vocab: int = 200, seed: int = 0):
    """A Markov chain with strong bigram structure, so the LM has signal:
    each word predicts ~3 successors 80% of the time. 0-based ids."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, (vocab, 3))
    toks = [0]
    for _ in range(n_tokens - 1):
        cur = toks[-1]
        if rng.rand() < 0.8:
            toks.append(int(succ[cur, rng.randint(3)]))
        else:
            toks.append(int(rng.randint(vocab)))
    return np.asarray(toks, np.int32), vocab


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--embed", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-iteration", type=int, default=150)
    p.add_argument("--long-len", type=int, default=256,
                   help="inference length for the long-context score")
    p.add_argument("--sequence-parallel",
                   choices=["ring", "ulysses", "zigzag"], default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    if args.sequence_parallel:
        raise NotImplementedError(
            f"--sequence-parallel {args.sequence_parallel} is not ported "
            "yet: it needs the flash carry kernel (kernel 2) and a process "
            "group over several cards, ROADMAP.md slice 4")

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch._device import resolve_device
    from bigdl_tpu_torch.models import TransformerLM

    device = resolve_device(args.device)
    toks, vocab = synthetic_ptb(40000, args.vocab)
    toks = toks + 1  # 1-based ids
    n = (len(toks) - 1) // args.seq_len
    X = toks[:n * args.seq_len].reshape(n, args.seq_len)
    Y = toks[1:n * args.seq_len + 1].reshape(n, args.seq_len)

    model = TransformerLM(vocab, embed_dim=args.embed, n_layer=args.layers,
                          n_head=args.heads, device=device)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    opt = optim.Optimizer(model, (X.astype(np.float32), Y), crit,
                          batch_size=args.batch_size, local=True,
                          device=device)
    # the transformer recipe: AdamW + linear warm-up into a cosine tail
    # (peak lr = learning_rate; one continuous schedule)
    warm = min(args.max_iteration - 1, max(1, args.max_iteration // 10))
    opt.set_optim_method(optim.AdamW(
        learning_rate=3e-3, weight_decay=0.01,
        learning_rate_schedule=optim.WarmupCosineDecay(
            warm, args.max_iteration)))
    opt.set_end_when(optim.max_iteration(args.max_iteration))
    trained = opt.optimize()

    # perplexity on training shards (the structure is learnable, so it
    # must drop well under the vocabulary-sized chance)
    trained.eval()
    with torch.no_grad():
        logp = trained(torch.from_numpy(X[:32]).to(device))
        nll = -logp.gather(
            -1, torch.from_numpy(Y[:32] - 1).long().to(device)[..., None]
        ).mean()
    ppl = float(torch.exp(nll))
    print(f"train-shard perplexity: {ppl:.1f} (chance ~{vocab})")

    long_x = torch.from_numpy(toks[:args.long_len][None, :]).to(device)
    with torch.no_grad():
        lp_long = trained(long_x)
    print(f"long-context forward ok: T={args.long_len} "
          f"(trained at T={args.seq_len}), logp shape "
          f"{tuple(lp_long.shape)}")
    return ppl


if __name__ == "__main__":
    main()
