"""The plain reference of a Fed-Sophia round (Alg. 1 of the paper), in
float32 over parameter dicts, one client after another.

Each client starts from the server model and runs J local steps: the
loss and its gradient g; at a refresh step (``(round * J + j) % tau ==
0``) the GNB estimate ``h_hat = (B*S) * g_s * g_s`` from the gradient
g_s of the loss against labels sampled from the model; then Sophia:

    m <- b1 m + (1 - b1) g
    h <- b2 h + (1 - b2) h_hat                 (refresh steps only)
    theta <- theta - lr * wd * theta
    theta <- theta - lr * clip(m / max(h, eps), -rho, rho)

m and h persist per client across rounds.  The server's new model is
the mean of the clients' models (identity uplink), or, with the int8
uplink, the old model plus the mean of each client's delta after a
stochastic int8 round trip: the delta's coordinates laid out in rows of
``quant_block`` (the leaves' coordinates in sorted-key order, one after
another, zero padded), each row scaled by its absolute maximum / 127,
``q = clip(floor(x / scale + u), -127, 127)``, ``xhat = q * scale``,
summed ``(0 + xhat_0 / C) + xhat_1 / C + ...``.

The model is trained in its weights' dtype over float32 master weights:
each forward (the loss's and the GNB's) reads every leaf rounded to the
dtype the weights were made in (bfloat16 but the router), and its
gradient is taken at that rounded point; m, h and the master weights
stay float32.

The round's random inputs are given: the gumbel draw of each client's
refresh and the uplink's U[0, 1) noise, the same the program got.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol

import torch

Params = Dict[str, torch.Tensor]


class LM(Protocol):
    """What the round needs of an arch's reference ``Model``."""

    def loss(self, p: Params, tokens, labels) -> torch.Tensor: ...

    def sampled_loss(self, p: Params, tokens, gumbel) -> torch.Tensor: ...


@dataclass(frozen=True)
class Hyper:
    """Fed-Sophia's hyper-parameters (the program's defaults but J, tau
    and lr, which the traffic sets)."""
    clients: int
    local_iters: int
    tau: int
    lr: float
    beta1: float = 0.9
    beta2: float = 0.95
    rho: float = 0.04
    eps: float = 1e-12
    weight_decay: float = 1e-4
    compressor: str = "identity"
    quant_block: int = 1024


def grads(fn: Callable[[Params], torch.Tensor], theta: Params):
    """``(fn(theta), d fn / d theta)`` with every leaf's gradient (zeros
    for a leaf the loss does not reach)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    loss = fn(leaves)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), gs)}


def seen_as(p: Params, dtypes: Dict[str, torch.dtype]) -> Params:
    """``p`` with every leaf rounded to its dtype of ``dtypes`` (to
    nearest even), in float32; the gradient passes as if unrounded."""
    out = {}
    for k, v in p.items():
        dt = dtypes[k]
        out[k] = v if dt == v.dtype else v + (v.detach().to(dt).to(v.dtype)
                                              - v.detach())
    return out


def packed_delta(t: Params, theta: Params, block: int) -> torch.Tensor:
    """``t - theta`` laid out in rows of ``block`` coordinates: the leaves
    in sorted-key order, flattened one after another, zero padded."""
    keys = sorted(t)
    n = sum(t[k].numel() for k in keys)
    rows = -(-n // block)
    x = torch.zeros(rows * block, dtype=torch.float32,
                    device=t[keys[0]].device)
    off = 0
    for k in keys:
        size = t[k].numel()
        x[off:off + size] = (t[k] - theta[k]).reshape(-1)
        off += size
    return x.view(rows, block)


def int8_roundtrip_(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The int8 stochastic round trip of the rows of ``x``, in place;
    ``noise`` U[0, 1) of ``x``'s shape."""
    scale = x.abs().amax(dim=1, keepdim=True) / 127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return x.div_(safe).add_(noise).floor_().clamp_(-127, 127).mul_(scale)


def unpacked(x: torch.Tensor, like: Params) -> Params:
    """The rows ``x`` of `packed_delta` as views keyed like ``like``."""
    out, off, flat = {}, 0, x.view(-1)
    for k in sorted(like):
        size = like[k].numel()
        out[k] = flat[off:off + size].view(like[k].shape)
        off += size
    return out


class FedRef:
    """The reference federated run: the server model, every client's m
    and h, and a round at a time."""

    def __init__(self, model: LM, hyper: Hyper, theta0: Params):
        self.model = model
        self.hp = hyper
        self.dtypes = {k: v.dtype for k, v in theta0.items()}
        self.theta = {k: v.detach().to(torch.float32).clone()
                      for k, v in theta0.items()}
        z = {k: torch.zeros_like(v) for k, v in self.theta.items()}
        self.m = [{k: v.clone() for k, v in z.items()}
                  for _ in range(hyper.clients)]
        self.h = [{k: v.clone() for k, v in z.items()}
                  for _ in range(hyper.clients)]

    def local(self, i: int, r: int, tokens, labels, gumbel) -> tuple:
        """Client ``i``'s J local steps of round ``r`` from the server
        model: its new model and mean loss."""
        hp, model = self.hp, self.model
        t = {k: v.clone() for k, v in self.theta.items()}
        m, h = self.m[i], self.h[i]
        losses = []
        n_tok = labels.numel()
        for j in range(hp.local_iters):
            loss, g = grads(lambda p: model.loss(seen_as(p, self.dtypes),
                                                 tokens, labels), t)
            do_h = (r * hp.local_iters + j) % hp.tau == 0
            h_hat = None
            if do_h:
                _, h_hat = grads(lambda p: model.sampled_loss(
                    seen_as(p, self.dtypes), tokens, gumbel), t)
                for k in h_hat:     # a leaf at a time: one leaf's temporary
                    h_hat[k] = n_tok * h_hat[k] * h_hat[k]
            for k in t:
                m[k].mul_(hp.beta1).add_((1 - hp.beta1) * g[k])
                if do_h:
                    h[k].mul_(hp.beta2).add_((1 - hp.beta2) * h_hat[k])
                t[k].sub_(hp.lr * hp.weight_decay * t[k])
                step = torch.clamp(m[k] / torch.clamp(h[k], min=hp.eps),
                                   -hp.rho, hp.rho)
                t[k].sub_(hp.lr * step)
            losses.append(loss)
            del g, h_hat
        return t, torch.stack(losses).mean()

    def round(self, r: int, tokens, labels, gumbel: Callable[[int], torch.Tensor],
              uplink: Optional[Callable[[int], torch.Tensor]] = None
              ) -> torch.Tensor:
        """Round ``r`` over ``tokens, labels (C, B, S)``; ``gumbel(i)`` is
        client i's refresh draw ``(B, S, Vp)``, ``uplink(i)`` its uplink
        noise ``(rows, quant_block)``.  Returns the round's loss, the
        mean over clients of each client's mean over its steps."""
        hp = self.hp
        C = hp.clients
        agg: Optional[torch.Tensor] = None
        losses: List[torch.Tensor] = []
        for i in range(C):
            t, loss = self.local(i, r, tokens[i], labels[i], gumbel(i))
            losses.append(loss)
            if hp.compressor == "identity":
                part = torch.cat([t[k].reshape(-1) for k in sorted(t)])
            elif hp.compressor == "int8":
                part = int8_roundtrip_(
                    packed_delta(t, self.theta, hp.quant_block),
                    uplink(i)).view(-1)
            else:
                raise ValueError(f"compressor {hp.compressor!r}")
            del t
            part.div_(C)
            agg = part if agg is None else agg.add_(part)
            del part
        new = unpacked(agg, self.theta)
        if hp.compressor == "identity":
            self.theta = new
        else:
            for k in self.theta:
                self.theta[k].add_(new[k])
        return torch.stack(losses).mean()


def leaf_norms(tree: Params) -> Dict[str, float]:
    """Each leaf's L2 norm."""
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tree.items()}

