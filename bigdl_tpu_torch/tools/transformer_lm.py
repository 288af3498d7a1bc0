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

    python -m bigdl_tpu_torch.tools.transformer_lm --sequence-parallel ring

`--sequence-parallel {ring,zigzag,ulysses}` then checks that scheme, as
the reference's example does: `make_sequence_parallel_attention(...,
causal=True)` over a mesh of every card when there are two or more, else
of 4 shards on the one device (`["cpu"] * 4` with `--device cpu`), on
seeded f32 q, k, v of [1, H, `--long-len`, 16] (H the heads; for Ulysses
at least the shards), against `naive_attention` at rtol 1e-4, atol 1e-5.
On the card ring and zigzag run the flash carry kernel (kernel 2) for
each hop.
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
    if args.sequence_parallel:
        sequence_parallel_check(args.sequence_parallel, args.long_len,
                                args.heads, device)
    return ppl


def sequence_parallel_check(scheme: str, length: int, heads: int,
                            device: torch.device, shards: int = 4) -> float:
    """`scheme`'s causal attention over the sequence-parallel mesh (every
    card when there are two or more, else `shards` shards on `device`)
    against `naive_attention` on one device, at the reference's tolerance;
    prints the result and returns the largest absolute difference. Raises
    `RuntimeError` when they disagree."""
    from bigdl_tpu_torch.ops.attention_kernel import naive_attention
    from bigdl_tpu_torch.parallel import build_mesh
    from bigdl_tpu_torch.parallel.sequence import \
        make_sequence_parallel_attention
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = [torch.device("cuda", i) for i in range(n_cards)] \
        if n_cards >= 2 else [device] * shards
    n = len(devices)
    h = heads if scheme in ("ring", "zigzag") else max(heads, n)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, h, length, 16)
                                .astype(np.float32)).to(device)
               for _ in range(3))
    attn = make_sequence_parallel_attention(
        build_mesh(data=n, devices=devices), scheme=scheme,
        axis_name="data", causal=True)
    with torch.no_grad():
        got = attn(q, k, v).to(device)
        want = naive_attention(q, k, v, causal=True)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise RuntimeError(
            f"sequence-parallel ({scheme}) attention over {n} devices "
            f"differs from single-device by {err:.3e}")
    print(f"sequence-parallel ({scheme}) attention over {n} devices "
          f"matches single-device (T={length}, max abs err {err:.3e})")
    return err


if __name__ == "__main__":
    main()
