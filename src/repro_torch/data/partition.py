"""Non-IID client partitioners: a copy of the JAX package's numpy-only
``repro/data/partition.py``, so a partition is the same for the same
integer seed in both packages (tests/test_torch_robust.py).

Three composable skews over a labelled sample pool, all host-side
numpy and **deterministic per integer seed** (independent
`numpy.random.default_rng` streams, so a partition can
be recomputed from the config alone):

* `dirichlet_label_partition` — label skew: each class's samples are
  apportioned across clients by proportions drawn from
  ``Dirichlet(alpha * 1_C)``.  ``alpha`` is the *concentration knob*:
  large alpha approaches the IID uniform split, small alpha
  concentrates each class on few clients (alpha=0.1 is the standard
  pathological setting).  Every client is guaranteed at least
  ``min_per_client`` samples (pinned, together with determinism and
  the alpha-monotone concentration statistic, by the JAX package's
  tests/test_data.py).
* `quantity_skew_sizes` — per-client dataset-size skew: client shares
  of the pool drawn from ``Dirichlet(alpha * 1_C)``, apportioned by
  largest remainder, minimum one sample each.
* `feature_shift` — per-client input-distribution shift: client c
  sees ``exp(severity * g_c) * x + severity * b_c`` with per-client
  standard-normal ``g_c, b_c`` (severity 0 is the identity).

`equalize` resamples ragged per-client index lists to the engine's
fixed ``(C, n_per)`` matrix (with replacement only when a client owns
fewer than ``n_per`` uniques), so skewed partitions stack exactly
like the IID ones from `repro_torch.data.synthetic`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _apportion(rng, total: int, shares: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of `total` items by `shares`
    (a probability vector): exact sum, deterministic tie order."""
    raw = shares * total
    counts = np.floor(raw).astype(np.int64)
    rem = total - int(counts.sum())
    if rem > 0:
        order = np.argsort(-(raw - counts), kind="stable")
        counts[order[:rem]] += 1
    return counts


def _enforce_min(parts: List[np.ndarray],
                 min_per_client: int) -> List[np.ndarray]:
    """Move samples from the largest clients until every client owns
    at least `min_per_client` (deterministic: always steal the tail
    of the currently-largest client)."""
    parts = [np.asarray(p, np.int64).copy() for p in parts]
    for i in range(len(parts)):
        while parts[i].size < min_per_client:
            donor = int(np.argmax([p.size for p in parts]))
            if parts[donor].size <= min_per_client:
                raise ValueError(
                    f"cannot give every client {min_per_client} "
                    f"samples: pool too small")
            parts[i] = np.append(parts[i], parts[donor][-1])
            parts[donor] = parts[donor][:-1]
    return parts


def dirichlet_label_partition(labels, num_clients: int, alpha: float,
                              seed: int, min_per_client: int = 1
                              ) -> List[np.ndarray]:
    """Label-skewed split of a labelled pool.

    For each class, the class's (shuffled) samples are divided among
    the ``num_clients`` clients by proportions drawn from
    ``Dirichlet(alpha * 1_C)``.  Returns a list of C sorted int64
    index arrays (ragged; see `equalize`).  Deterministic per
    ``seed``; every client keeps at least ``min_per_client`` samples.
    """
    if alpha <= 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    rng = np.random.default_rng([int(seed), 17])
    parts: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        if idx.size == 0:
            continue
        idx = rng.permutation(idx)
        shares = rng.dirichlet(alpha * np.ones(num_clients))
        counts = _apportion(rng, idx.size, shares)
        for i, chunk in enumerate(np.split(idx, np.cumsum(counts)[:-1])):
            parts[i].append(chunk)
    merged = [np.sort(np.concatenate(p)) if p else
              np.zeros((0,), np.int64) for p in parts]
    return _enforce_min(merged, min_per_client)


def quantity_skew_sizes(n: int, num_clients: int, alpha: float,
                        seed: int, min_per_client: int = 1
                        ) -> np.ndarray:
    """(C,) per-client dataset sizes summing to ``n``, shares drawn
    from ``Dirichlet(alpha * 1_C)``, each at least ``min_per_client``.
    Deterministic per ``seed``."""
    if alpha <= 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if n < num_clients * min_per_client:
        raise ValueError(
            f"n={n} < num_clients*min_per_client="
            f"{num_clients * min_per_client}")
    rng = np.random.default_rng([int(seed), 18])
    sizes = _apportion(rng, n, rng.dirichlet(alpha * np.ones(num_clients)))
    # deterministic rebalance up to the minimum
    while (sizes < min_per_client).any():
        need = int(np.argmin(sizes))
        donor = int(np.argmax(sizes))
        sizes[need] += 1
        sizes[donor] -= 1
    return sizes


def subsample(parts: Sequence[np.ndarray], sizes: np.ndarray,
              seed: int) -> List[np.ndarray]:
    """Apply quantity skew to a partition: keep a ``sizes[i]``-element
    deterministic random subset of each client's indices (capped at
    what the client owns)."""
    rng = np.random.default_rng([int(seed), 20])
    out = []
    for p, s in zip(parts, sizes):
        p = np.asarray(p, np.int64)
        k = min(int(s), p.size)
        out.append(np.sort(rng.choice(p, size=k, replace=False)))
    return out


def equalize(parts: Sequence[np.ndarray], n_per: int,
             seed: int) -> np.ndarray:
    """Resample ragged per-client index lists to the engine's fixed
    (C, n_per) int32 matrix — without replacement when a client owns
    >= n_per uniques, with replacement otherwise (oversampling small
    clients preserves their skewed effective distribution)."""
    rng = np.random.default_rng([int(seed), 21])
    out = np.zeros((len(parts), n_per), np.int32)
    for i, p in enumerate(parts):
        p = np.asarray(p, np.int64)
        if p.size == 0:
            raise ValueError(f"client {i} owns no samples")
        out[i] = rng.choice(p, size=n_per, replace=p.size < n_per)
    return out


def feature_shift(x_clients, severity: float, seed: int):
    """Per-client feature shift of a stacked (C, ...) input array:
    client c sees ``exp(severity * g_c) * x + severity * b_c`` with
    per-client standard-normal gain/offset draws.  severity=0.0 is
    the identity.  Deterministic per ``seed``; returns a new float32
    numpy array."""
    x = np.asarray(x_clients, np.float32)
    if severity == 0.0:
        return x.copy()
    C = x.shape[0]
    rng = np.random.default_rng([int(seed), 19])
    tail = (1,) * (x.ndim - 1)
    gain = np.exp(severity * rng.standard_normal(C)).reshape((C,) + tail)
    bias = (severity * rng.standard_normal(C)).reshape((C,) + tail)
    return (gain * x + bias).astype(np.float32)


def label_marginals(labels, parts: Sequence[np.ndarray],
                    num_classes: int) -> np.ndarray:
    """(C, num_classes) per-client label distribution of a partition."""
    labels = np.asarray(labels)
    out = np.zeros((len(parts), num_classes), np.float64)
    for i, p in enumerate(parts):
        counts = np.bincount(labels[np.asarray(p, np.int64)],
                             minlength=num_classes)
        out[i] = counts / max(1, counts.sum())
    return out


def label_concentration(marginals: np.ndarray) -> float:
    """Scalar skew statistic: the mean (over clients) max class share.
    1/num_classes for perfectly IID clients, -> 1.0 as each client
    collapses onto a single class — monotone in 1/alpha in
    expectation (pinned statistically by the JAX package's
    tests/test_data.py)."""
    return float(np.mean(marginals.max(axis=1)))
