"""Offline synthetic datasets: seeded class-conditional images of MNIST
shape (28x28x1, 10 classes) and the non-IID Dirichlet partitioner.

The values a `torch.Generator` draws differ from the JAX package's;
shapes, cardinality and semantics are the same.  `dirichlet_partition`
is numpy given an int seed and equals the JAX package's output for the
same seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_SIZE = 28
NUM_CLASSES = 10


def make_image_data(generator: torch.Generator, n: int,
                    dataset: str = "mnist", noise: float = 0.35,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional smooth prototypes + Gaussian noise, drawn on the
    generator's device.  Returns NHWC images ``(n, 28, 28, 1)`` fp32 and
    int64 labels ``(n,)``.

    'fmnist' uses a higher intra-class amplitude spread (the harder
    dataset, as in the paper)."""
    gen = generator
    dev = gen.device
    # smooth prototypes: random 7x7 patterns upsampled (bicubic)
    low = torch.randn(NUM_CLASSES, 1, 7, 7, generator=gen, device=dev)
    protos = F.interpolate(low, size=(IMAGE_SIZE, IMAGE_SIZE),
                           mode="bicubic", align_corners=False)
    protos = protos.permute(0, 2, 3, 1)                    # NHWC
    protos = protos / (protos.std(dim=(1, 2, 3), keepdim=True,
                                  correction=0) + 1e-6)
    y = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=dev)
    spread = 0.35 if dataset == "fmnist" else 0.15
    amp = 1.0 + spread * torch.randn(n, 1, 1, 1, generator=gen, device=dev)
    x = amp * protos[y] + noise * torch.randn(
        n, IMAGE_SIZE, IMAGE_SIZE, 1, generator=gen, device=dev)
    return x.to(device or dev), y.to(device or dev)


def dirichlet_partition(seed: int, labels, num_clients: int,
                        alpha: float = 0.5) -> np.ndarray:
    """Non-IID split: per-client class mixture ~ Dirichlet(alpha).

    Returns an ``(C, n_per_client)`` int32 index matrix (equalized with
    replacement so it stacks)."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    n = labels.shape[0]
    rng = np.random.default_rng(int(seed))
    by_class = [np.where(labels == c)[0] for c in range(NUM_CLASSES)]
    n_per = n // num_clients
    out = np.zeros((num_clients, n_per), np.int32)
    for i in range(num_clients):
        mix = rng.dirichlet(alpha * np.ones(NUM_CLASSES))
        counts = rng.multinomial(n_per, mix)
        idx = np.concatenate([
            rng.choice(by_class[c], size=k, replace=len(by_class[c]) < k)
            for c, k in enumerate(counts) if k > 0])
        rng.shuffle(idx)
        out[i] = idx[:n_per]
    return out


def train_test_split(part: np.ndarray, test_frac: float = 0.25):
    """Per-client 75/25 split (paper §V-A)."""
    n_test = int(part.shape[1] * test_frac)
    return part[:, n_test:], part[:, :n_test]


def client_batches(generator: torch.Generator, x: torch.Tensor,
                   y: torch.Tensor, part: np.ndarray, batch_size: int):
    """Sample one round of per-client minibatches -> leaves
    ``(C, b, ...)``, on ``x``'s device."""
    C, n_per = part.shape
    b = min(batch_size, n_per)
    cols = torch.randint(0, n_per, (C, b), generator=generator,
                         device=generator.device).to(x.device)
    idx = torch.gather(torch.as_tensor(part, device=x.device).long(), 1,
                       cols)
    return {"x": x[idx], "y": y[idx]}
