"""The Sophia update (Liu et al. 2023) as Fed-Sophia uses it (Alg. 1).

Two forms with the same per-coordinate arithmetic, as in the JAX
package:

* the pytree form (`sophia_step` and its parts), over parameter dicts:
  the reference the paper-facing code reads.  On the card it always
  runs the fused kernel through
  `repro_torch.kernels.ops.sophia_fused_step` (one launch of the pytree
  form of ``csrc/sophia_update.cu`` over the leaves where they lie); on
  the CPU, the per-leaf tensor arithmetic of its parts;
* the flat form (`sophia_step_flat`), over packed wire buffers: what the
  round engine calls, the kernel fed directly with no pack or unpack;
  on its leaf route it reads the grads and h_hat as the loss/grad
  boundary's leaves and stores the next forward's params leaves itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.cost import shape_only
from repro_torch.kernels.ref import store_as
from repro_torch.kernels.sophia_update import (sophia_update_batched,
                                               sophia_update_flat,
                                               sophia_update_leaves)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_zeros_like


class SophiaState(NamedTuple):
    m: object   # EMA of gradients       (Eq. 9)
    h: object   # EMA of Hessian diag    (Eq. 10)


def init_state(params) -> SophiaState:
    return SophiaState(m=tree_zeros_like(params), h=tree_zeros_like(params))


def update_m(m, grads, beta1: float):
    """Eq. 9: m <- b1 m + (1-b1) g."""
    return tree_map(lambda mm, g: beta1 * mm + (1.0 - beta1) * g, m, grads)


def update_h(h, h_hat, beta2: float):
    """Eq. 10: h <- b2 h + (1-b2) h_hat."""
    return tree_map(lambda hh, e: beta2 * hh + (1.0 - beta2) * e, h, h_hat)


def clip(z, rho: float):
    """Eq. 11: elementwise clip to [-rho, rho] (NaN passes through)."""
    return torch.clamp(z, -rho, rho)


def apply_update(params, m, h, *, lr: float, rho: float, eps: float,
                 weight_decay: float):
    """Alg. 1 lines 15-16: decoupled weight decay, then the clipped
    pre-conditioned step  theta <- theta - lr*clip(m / max(h, eps), rho)."""
    def leaf(theta, mm, hh):
        dtype = theta.dtype
        theta = theta - lr * weight_decay * theta
        step = clip(mm / torch.clamp(hh, min=eps), rho)
        return store_as(theta - lr * step, dtype)
    return tree_map(leaf, params, m, h)


def sophia_step(params, grads, state: SophiaState, h_hat, do_h_update, *,
                lr, beta1, beta2, rho, eps, weight_decay):
    """One full local iteration of Alg. 1 (lines 7-16) over parameter
    dicts.  ``h_hat``: the GNB estimate (read only when
    ``do_h_update``, a host bool).  The device decides the route: CUDA
    trees run the fused kernel once over the trees' leaves, CPU trees the
    per-leaf tensor arithmetic; storage-less trees (a cost trace) take
    the kernel's shape-only path, as on the card.  Returns ``(params,
    SophiaState)``."""
    leaf = tree_leaves(params)[0]
    if leaf.device.type == "cuda" or shape_only(leaf):
        from repro_torch.kernels.ops import sophia_fused_step
        params, m, h = sophia_fused_step(
            params, state.m, state.h, grads, h_hat, do_h_update, lr=lr,
            beta1=beta1, beta2=beta2, rho=rho, eps=eps,
            weight_decay=weight_decay)
        return params, SophiaState(m=m, h=h)
    m = update_m(state.m, grads, beta1)
    h = update_h(state.h, h_hat, beta2) if do_h_update else state.h
    params = apply_update(params, m, h, lr=lr, rho=rho, eps=eps,
                          weight_decay=weight_decay)
    return params, SophiaState(m=m, h=h)


def sophia_step_flat(theta, m, h, grads, h_hat, do_h_update, *, lr, beta1,
                     beta2, rho, eps, weight_decay, inplace: bool = False,
                     spec=None, leaves=None):
    """One local iteration (Alg. 1 lines 7-16) over packed buffers.

    ``(clients, rows, cols)`` stacks go to the client-batched entry (one
    launch for the whole cohort), ``(rows, cols)`` buffers to the flat
    one.  With ``grads`` a dict of leaves (the leaf route: fp32 resident
    buffers of layout ``spec``, `sophia_update_leaves`), ``h_hat`` a
    dict of leaves or a buffer, the step runs in place and stores the
    new theta into the ``leaves`` dict's buffers (None: no store).  On
    the card the kernel always runs; on the CPU its plain version.
    ``do_h_update`` and ``lr`` are host scalars.  Returns ``(theta, m,
    h)``."""
    if isinstance(grads, dict):
        return sophia_update_leaves(
            theta, m, h, grads, h_hat, do_h_update, lr, spec=spec,
            out=leaves, beta1=beta1, beta2=beta2, rho=rho, eps=eps,
            weight_decay=weight_decay)[:3]
    fn = sophia_update_batched if theta.ndim == 3 else sophia_update_flat
    return fn(theta, m, h, grads, h_hat, do_h_update, lr, beta1=beta1,
              beta2=beta2, rho=rho, eps=eps, weight_decay=weight_decay,
              inplace=inplace)
