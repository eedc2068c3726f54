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
                 gumbel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The h_hat dict (same keys and shapes as ``params``).  ``params``
    leaves may carry a leading client axis, with ``batch`` and
    ``gumbel`` batched alike; each client's estimate uses only its own
    loss.  Evaluated as ``(B * g) * g``, the JAX order."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = task.sampled_loss(leaves, batch, gumbel)
    keys = list(leaves)
    g_hat = torch.autograd.grad(loss.sum(), [leaves[k] for k in keys])
    B = task.gnb_batch_size(batch)
    return {k: B * g * g for k, g in zip(keys, g_hat)}
