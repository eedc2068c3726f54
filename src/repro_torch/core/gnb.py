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

from repro_torch.obs.spans import GNB, annotate, spanned


def gnb_estimate(task, params: Dict[str, torch.Tensor], batch,
                 gumbel: torch.Tensor,
                 microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """The h_hat dict (same keys and shapes as ``params``).  ``params``
    leaves may carry a leading client axis, with ``batch`` and
    ``gumbel`` batched alike; each client's estimate uses only its own
    loss.  Evaluated as ``(B * g) * g``, the JAX order, with B the whole
    batch.

    ``microbatches`` n > 1 takes g_hat as the JAX engine's micro-batched
    ``value_and_grad`` does (`value_and_grads`): the batch
    axis split into n equal consecutive slices, ``sum_i g_i / n`` in
    order; micro-batch i reads the i-th slice of ``gumbel``'s batch axis
    (its draws laid out micro-batch by micro-batch).  It runs inside the
    profiler range `repro_torch.obs.spans.GNB`, its backward too."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    _, g_hat = value_and_grads(
        lambda p, mb: task.sampled_loss(p, mb, mb["gumbel"]), leaves,
        {**batch, "gumbel": gumbel}, microbatches, GNB)
    B = task.gnb_batch_size(batch)
    with annotate(GNB):
        return {k: B * g * g for k, g in zip(leaves, g_hat)}


def value_and_grads(loss_fn, leaves: Dict[str, torch.Tensor], batch,
                    microbatches: int, span: str,
                    create_graph: bool = False):
    """``(loss, grads)``: the per-client losses ``loss_fn(leaves, mb)``
    and the grads of their sum (`leaf_grads`, in ``leaves``' order),
    over the n consecutive slices of the batch (`microbatch_slices`)
    as ``sum_i loss_i / n`` and ``sum_i g_i / n`` in order (the JAX
    engine's micro-batched ``value_and_grad``; the whole batch for n <=
    1).  Each forward, and the backward it starts, runs inside the
    profiler range ``span`` (`repro_torch.obs.spans.spanned`), and so
    do the sums; the backward's seed and zero-filled grads fall outside
    it."""
    keys = list(leaves)
    xs = [leaves[k] for k in keys]
    n = microbatches
    loss = grads = None
    for mb in microbatch_slices(batch, n):
        loss_i, total = spanned(
            span, lambda *ls: _with_sum(loss_fn(dict(zip(keys, ls)), mb)),
            xs)
        g = leaf_grads(total, xs, create_graph)
        loss_i = loss_i.detach()
        if n <= 1:
            return loss_i, g
        with annotate(span):
            loss = loss_i / n if loss is None else loss + loss_i / n
            grads = accumulate(grads, g, n)
    return loss, grads


def _with_sum(loss: torch.Tensor):
    return loss, loss.sum()


def leaf_grads(loss: torch.Tensor, leaves, create_graph: bool = False):
    """``torch.autograd.grad(loss, leaves)``, where a leaf that reaches
    no op gets zeros of its shape, as ``jax.grad`` gives it: an LM's
    zero-length layer stack (a depth below its block pattern's length),
    or the token table of an untied embedding-input config, which reads
    ``embeds``.  ``create_graph`` keeps the graph of every grad that has
    one (a Hessian-vector product's)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                create_graph=create_graph)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


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
