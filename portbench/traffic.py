"""The one generator of the benchmark's traffic: the token batches a
traffic mix asks for, and the random inputs of the rounds that the
check compares, all drawn on the device from the seed.

Tokens follow a Markov stream (the program's ``make_token_batch``, drawn
here in bulk: every round of the pool in one chain): y_t =
perm[y_{t-1}] for a seeded permutation of the vocabulary, resampled
uniformly with probability 0.15; labels are the stream shifted by one,
wrapping.  Every seed gives the same sizes; only the values change.
"""
from __future__ import annotations

import torch

#: generator salts: weights, the batch pool, the checked rounds' gumbel
#: draws and uplink noise (plus the round), the window's round generator
WEIGHTS, POOL, GUMBEL, UPLINK, ROUNDS = 0, 1, 100, 200, 300


def generator(device, seed: int, salt: int) -> torch.Generator:
    """A generator on ``device`` for ``(seed, salt)``; any whole seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (2 ** 63 - 1))


def token_pool(gen: torch.Generator, rounds: int, clients: int, batch: int,
               seq: int, vocab: int):
    """``rounds`` rounds of batches: ``tokens`` and ``labels`` int64
    ``(rounds, clients, batch, seq)`` on the generator's device."""
    dev = gen.device
    perm = torch.randperm(vocab, generator=gen, device=dev)
    shape = (rounds, clients, batch)
    first = torch.randint(0, vocab, shape, generator=gen, device=dev)
    flips = torch.rand((seq - 1,) + shape, generator=gen, device=dev) < 0.15
    rnd = torch.randint(0, vocab, (seq - 1,) + shape, generator=gen,
                        device=dev)
    toks = [first]
    for t in range(seq - 1):
        toks.append(torch.where(flips[t], rnd[t], perm[toks[-1]]))
    tokens = torch.stack(toks, dim=-1)
    labels = torch.roll(tokens, -1, dims=-1)
    return tokens, labels


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` of ``shape``, fp32."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return u.log_().neg_().log_().neg_()


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """U[0, 1) noise of ``shape``, fp32."""
    return torch.rand(shape, generator=gen, device=gen.device)
