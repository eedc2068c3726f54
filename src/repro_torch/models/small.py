"""The paper's evaluation models: MLP and CNN image classifiers
(MNIST/FMNIST-shaped inputs 28x28x1, 10 classes).

Parameters are a ``dict[str, Tensor]`` keyed like the JAX package's
pytree.  Every public function also takes parameters with a leading
client axis ``N`` (batch leaves then carry it too, ``(N, B, ...)``): the
client axis is a batch dimension written out, in place of ``vmap``, and
the loss comes back per client, shape ``(N,)``.

The CNN keeps the JAX layouts at its public functions — HWIO weights,
NHWC inputs — and permutes to NCHW / OIHW only inside `CNNTask.logits`,
where the client axis becomes the convolution's groups.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

NUM_CLASSES = 10

Params = Dict[str, torch.Tensor]


def dense_init(generator: torch.Generator, d_in: int,
               d_out: int) -> torch.Tensor:
    """N(0, 1/d_in) weights, as the JAX package's ``dense_init``."""
    scale = 1.0 / math.sqrt(d_in)
    return torch.randn(d_in, d_out, generator=generator,
                       device=generator.device) * scale


def _ce(logits, labels):
    """Mean cross-entropy over the batch axis (the last axis of
    ``labels``)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - picked, dim=-1)


def gumbel_noise(generator: torch.Generator, shape,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))``, drawn on the generator's
    device and placed on ``device`` (the generator's when None)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device or generator.device)


class _Task:
    num_classes: int

    def loss(self, params: Params, batch, rng=None):
        return _ce(self.logits(params, batch), batch["y"])

    def sampled_loss(self, params: Params, batch, gumbel: torch.Tensor):
        """CE against labels drawn from the model's own softmax:
        ``argmax(logits + gumbel)``, which is how
        ``jax.random.categorical`` samples."""
        logits = self.logits(params, batch)
        y = torch.argmax(logits.detach() + gumbel, dim=-1)
        return _ce(logits, y)

    def accuracy(self, params: Params, batch):
        hit = torch.argmax(self.logits(params, batch), -1) == batch["y"]
        return hit.to(torch.float32).mean(dim=-1)

    def gnb_batch_size(self, batch) -> int:
        return int(batch["y"].shape[-1])


class MLPTask(_Task):
    """784 -> hidden -> hidden -> 10, ReLU (paper's MLP)."""

    def __init__(self, hidden: int = 128, num_classes: int = NUM_CLASSES):
        self.hidden = hidden
        self.num_classes = num_classes

    def init(self, generator: torch.Generator, device=None) -> Params:
        params = {
            "w1": dense_init(generator, 784, self.hidden),
            "b1": torch.zeros(self.hidden, device=generator.device),
            "w2": dense_init(generator, self.hidden, self.hidden),
            "b2": torch.zeros(self.hidden, device=generator.device),
            "w3": dense_init(generator, self.hidden, self.num_classes),
            "b3": torch.zeros(self.num_classes, device=generator.device),
        }
        return {k: v.to(device or generator.device)
                for k, v in params.items()}

    def logits(self, params: Params, batch):
        n_lead = params["w1"].ndim - 2
        x = batch["x"]
        x = x.reshape(x.shape[:n_lead + 1] + (-1,))
        h = F.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
        h = F.relu(h @ params["w2"] + params["b2"].unsqueeze(-2))
        return h @ params["w3"] + params["b3"].unsqueeze(-2)


class CNNTask(_Task):
    """2x (conv3x3 + relu + maxpool2) -> fc (paper's CNN)."""

    def __init__(self, channels: Tuple[int, int] = (16, 32),
                 num_classes: int = NUM_CLASSES):
        self.channels = channels
        self.num_classes = num_classes

    def init(self, generator: torch.Generator, device=None) -> Params:
        c1, c2 = self.channels
        dev = generator.device
        params = {
            "conv1": torch.randn(3, 3, 1, c1, generator=generator,
                                 device=dev) / math.sqrt(9),
            "bc1": torch.zeros(c1, device=dev),
            "conv2": torch.randn(3, 3, c1, c2, generator=generator,
                                 device=dev) / math.sqrt(9 * c1),
            "bc2": torch.zeros(c2, device=dev),
            "fc": dense_init(generator, 7 * 7 * c2, self.num_classes),
            "bfc": torch.zeros(self.num_classes, device=dev),
        }
        return {k: v.to(device or dev) for k, v in params.items()}

    def logits(self, params: Params, batch):
        batched = params["conv1"].ndim == 5
        x = batch["x"]
        if not batched:
            params = {k: v.unsqueeze(0) for k, v in params.items()}
            x = x.unsqueeze(0)
        if x.ndim == 4:                      # (N, B, H, W) -> channel 1
            x = x.unsqueeze(-1)
        N, B, H, W, cin = x.shape
        # NHWC per client -> NCHW with the clients side by side in the
        # channel axis: (B, N*Cin, H, W), one conv group per client
        x = x.permute(1, 0, 4, 2, 3).reshape(B, N * cin, H, W)
        for wk, bk in (("conv1", "bc1"), ("conv2", "bc2")):
            w = params[wk]                   # (N, 3, 3, Cin, Cout) HWIO
            cin, cout = w.shape[3], w.shape[4]
            w = w.permute(0, 4, 3, 1, 2).reshape(N * cout, cin, 3, 3)
            x = F.conv2d(x, w, padding=1, groups=N)   # SAME, stride 1
            x = F.relu(x + params[bk].reshape(1, N * cout, 1, 1))
            x = F.max_pool2d(x, kernel_size=2, stride=2)   # 2x2, VALID
        c, hh, ww = x.shape[1] // N, x.shape[2], x.shape[3]
        # back to NHWC before the flatten, as the JAX model flattens
        x = x.reshape(B, N, c, hh, ww).permute(1, 0, 3, 4, 2)
        x = x.reshape(N, B, hh * ww * c)
        out = x @ params["fc"] + params["bfc"].unsqueeze(-2)
        return out if batched else out[0]
