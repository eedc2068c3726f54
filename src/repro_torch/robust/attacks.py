"""Byzantine fault injection over the packed wire layout.

Membership is host arithmetic: the byzantine and label-noise subsets
are numpy draws from ``RobustConfig.seed`` (independent streams), equal
element for element to the JAX package's, so a run replays bit for bit.
With ``attack="none"`` or an empty subset the callers never call
`attack_wires`.

Wire attacks transform a malicious client's packed uplink buffer, never
its local training; shape and dtype stay.  The engine's direct path
applies them to the contribution delta (client model minus the
round-start model), which is what an uncompressed wire carries.

Randomness: ``random_wire``'s gaussian comes through the RNG seam, drawn
from a `torch.Generator` or injected (the tests inject the JAX package's
draw, ``jax.random.normal(fold_in(key, ATTACK_SALT), shape)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTACKS

#: the JAX package's fold_in salt of the random-wire draw
#: (``repro/robust/attacks.py``); the port's tests rebuild its draws
ATTACK_SALT = 0xB12A


def _subset_mask(seed_stream, fraction: float,
                 num_clients: int) -> np.ndarray:
    n = int(round(fraction * num_clients))
    n = max(0, min(num_clients, n))
    mask = np.zeros(num_clients, dtype=bool)
    if n:
        rng = np.random.default_rng(seed_stream)
        mask[rng.permutation(num_clients)[:n]] = True
    return mask


def _check_attack(robust) -> None:
    if robust.attack not in ATTACKS:
        raise ValueError(
            f"unknown attack {robust.attack!r} (want one of {ATTACKS})")


def byzantine_mask(robust, num_clients: int) -> np.ndarray:
    """(C,) bool: the clients that mount the configured wire attack;
    all False when the attack is off."""
    _check_attack(robust)
    if robust.attack == "none":
        return np.zeros(num_clients, dtype=bool)
    return _subset_mask([robust.seed, 0], robust.attack_fraction,
                        num_clients)


def label_noise_mask(robust, num_clients: int) -> np.ndarray:
    """(C,) bool: the clients that train on noisy labels (independent of
    the byzantine subset)."""
    return _subset_mask([robust.seed, 1], robust.label_noise_fraction,
                        num_clients)


def wire_attack_active(robust, num_clients: int) -> bool:
    """Whether `attack_wires` would change anything; callers gate on it,
    so a benign run never reaches the attack."""
    return (robust.attack != "none"
            and bool(byzantine_mask(robust, num_clients).any()))


def attack_wires(robust, wires, mask, *, noise=None, generator=None):
    """The configured byzantine transform of the masked rows of a packed
    ``(N, rows, cols)`` stack, in the stack's shape and dtype:

    * ``sign_flip``   — ``-x``;
    * ``scale``       — ``attack_scale * x``;
    * ``random_wire`` — gaussian noise times the row's own standard
      deviation (floored at 1e-8): ``noise`` ``(N, rows, cols)`` fp32 if
      given, else drawn from ``generator``.

    ``mask``: ``(N,)`` bool per row (numpy or a tensor)."""
    _check_attack(robust)
    if robust.attack == "none":
        return wires
    x = wires.to(torch.float32)
    m = torch.as_tensor(np.asarray(mask, dtype=bool) if not isinstance(
        mask, torch.Tensor) else mask, device=x.device).reshape(
            (-1,) + (1,) * (x.ndim - 1))
    if robust.attack == "sign_flip":
        evil = -x
    elif robust.attack == "scale":
        evil = robust.attack_scale * x
    else:  # random_wire
        std = torch.std(x, dim=tuple(range(1, x.ndim)), keepdim=True,
                        correction=0)
        if noise is None:
            if generator is None:
                raise ValueError("random_wire needs injected noise or a "
                                 "generator")
            noise = torch.randn(x.shape, generator=generator,
                                device=generator.device)
        noise = torch.as_tensor(noise).to(x.device, torch.float32)
        if noise.shape != x.shape:
            raise ValueError(f"attack noise has shape {tuple(noise.shape)}, "
                             f"want {tuple(x.shape)}")
        evil = noise * torch.clamp(std, min=1e-8)
    return torch.where(m, evil, x).to(wires.dtype)


def corrupt_labels(robust, labels, mask, num_classes: int) -> np.ndarray:
    """Label-noise clients: each masked client's labels resampled
    uniformly with probability ``label_noise_rate``.  ``labels``: host
    ints with leading client axis C; returns a fresh array, the same per
    ``robust.seed`` as the JAX package's.  Runs at data-build time."""
    out = np.array(labels)
    if robust.label_noise_fraction <= 0.0 or robust.label_noise_rate <= 0.0:
        return out
    rng = np.random.default_rng([robust.seed, 2])
    flip = rng.random(out.shape) < robust.label_noise_rate
    rand = rng.integers(0, num_classes, out.shape)
    flip &= np.asarray(mask, dtype=bool).reshape(
        (-1,) + (1,) * (out.ndim - 1))
    out[flip] = rand[flip]
    return out
