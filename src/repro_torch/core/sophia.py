"""The Sophia update (Liu et al. 2023) as Fed-Sophia uses it (Alg. 1),
over packed wire buffers: the flat form the round engine consumes.

The pytree form of the JAX package (``sophia_step``, reached through
``kernels/ops.py:sophia_fused_step``) waits for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.sophia_update import (sophia_update_batched,
                                               sophia_update_flat)


class SophiaState(NamedTuple):
    m: torch.Tensor   # EMA of gradients       (Eq. 9)
    h: torch.Tensor   # EMA of Hessian diag    (Eq. 10)


def sophia_step_flat(theta, m, h, grads, h_hat, do_h_update, *, lr, beta1,
                     beta2, rho, eps, weight_decay, inplace: bool = False):
    """One local iteration (Alg. 1 lines 7-16) over packed buffers.

    ``(clients, rows, cols)`` stacks go to the client-batched entry (one
    launch for the whole cohort), ``(rows, cols)`` buffers to the flat
    one.  On the card the kernel always runs; on the CPU its plain
    version.  ``do_h_update`` and ``lr`` are host scalars.  Returns
    ``(theta, m, h)``."""
    fn = sophia_update_batched if theta.ndim == 3 else sophia_update_flat
    return fn(theta, m, h, grads, h_hat, do_h_update, lr, beta1=beta1,
              beta2=beta2, rho=rho, eps=eps, weight_decay=weight_decay,
              inplace=inplace)
