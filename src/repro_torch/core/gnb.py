"""Gauss-Newton-Bartlett diagonal Hessian estimator (Alg. 2).

    1. compute logits phi(theta, x_b) on the minibatch
    2. sample y_b ~ softmax(logits)   (argmax(logits + gumbel))
    3. g_hat = grad of (1/B) sum CE(logits, y_b)   w.r.t. theta
    4. h_hat = B * g_hat ⊙ g_hat

The gumbel noise is an argument (the RNG seam): the engine draws it from
a `torch.Generator`, or the tests inject the JAX package's own draws.
"""
from __future__ import annotations

from typing import Dict

import torch


def gnb_estimate(task, params: Dict[str, torch.Tensor], batch,
                 gumbel: torch.Tensor,
                 microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """The h_hat dict (same keys and shapes as ``params``).  ``params``
    leaves may carry a leading client axis, with ``batch`` and
    ``gumbel`` batched alike; each client's estimate uses only its own
    loss.  Evaluated as ``(B * g) * g``, the JAX order, with B the whole
    batch.

    ``microbatches`` n > 1 takes g_hat as the JAX engine's micro-batched
    ``value_and_grad`` does (`FedEngine._value_and_grad`): the batch
    axis split into n equal consecutive slices, ``sum_i g_i / n`` in
    order; micro-batch i reads the i-th slice of ``gumbel``'s batch axis
    (its draws laid out micro-batch by micro-batch)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    keys = list(leaves)
    g_hat = None
    for mb in microbatch_slices({**batch, "gumbel": gumbel}, microbatches):
        loss = task.sampled_loss(leaves, mb, mb["gumbel"])
        g = leaf_grads(loss.sum(), [leaves[k] for k in keys])
        g_hat = accumulate(g_hat, g, microbatches)
    B = task.gnb_batch_size(batch)
    return {k: B * g * g for k, g in zip(keys, g_hat)}


def leaf_grads(loss: torch.Tensor, leaves):
    """``torch.autograd.grad(loss, leaves)``, where a zero-size leaf (an
    LM's zero-length layer stack, at a depth below its block pattern's
    length) reaches no op and gets its empty gradient."""
    live = [x for x in leaves if x.numel()]
    grads = iter(torch.autograd.grad(loss, live))
    return [next(grads) if x.numel() else torch.zeros_like(x)
            for x in leaves]


def labels_of(batch) -> torch.Tensor:
    """A batch's labels: ``y`` ``(*lead, B)`` of the image tasks, or an
    LM's ``labels`` ``(*lead, B, S)``."""
    return batch["y"] if "y" in batch else batch["labels"]


def batch_axis(batch) -> int:
    """The position of the batch axis B in every leaf of ``batch``
    (after its leading client axes)."""
    if "y" in batch:
        return batch["y"].ndim - 1
    return batch["labels"].ndim - 2


def microbatch_slices(batch, n: int):
    """The ``n`` consecutive equal slices of ``batch``'s batch axis
    (`batch_axis`; every leaf has it at that position), as the JAX
    engine's reshape to ``(n, B / n)`` lays them out; ``[batch]``
    itself for n <= 1."""
    if n <= 1:
        return [batch]
    axis = batch_axis(batch)
    B = int(labels_of(batch).shape[axis])
    if B % n:
        raise ValueError(f"a batch of {B} does not split into {n} "
                         "micro-batches")
    return [{k: v.narrow(axis, i * (B // n), B // n)
             for k, v in batch.items()} for i in range(n)]


def accumulate(acc, grads, n: int):
    """One micro-batch's term of the JAX engine's running mean: ``acc +
    g / n`` leaf by leaf (``g`` itself for n <= 1), ``acc`` None before
    the first (where the JAX scan's ``0 + g / n`` is ``g / n``)."""
    if n <= 1:
        return list(grads)
    if acc is None:
        return [g / n for g in grads]
    return [a + g / n for a, g in zip(acc, grads)]
