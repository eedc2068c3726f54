"""Stream compressors over the packed ``(rows, cols)`` fp32 wire buffer.

One compressor family serves every named stream of the round (uplink
model delta, downlink broadcast delta, hessian EMA): build one with
`make_stream_compressor(comm, stream, spec)`, which resolves the
stream's choice through ``CommConfig.stream(name)``.

Each compressor is a pair ``encode -> payload`` / ``decode ->
reconstruction`` plus the engine's entry points: ``roundtrip``
(decode(encode(x))), ``encode_delta`` (the whole uplink chain over
wire-layout state: delta against the received model, EF correction,
round-trip, new residual) and their ``*_batched`` forms over ``(N, rows,
cols)`` client stacks.  `StochasticQuant`, `TopK` and `SignSGD` run
their round-trips through the kernels of `repro_torch.kernels.quantize`
(the kernel on the card, its plain version on the CPU).  ``serialize``
renders a payload to its canonical little-endian wire bytes, the JAX
package's layout byte for byte.

Randomness (the RNG seam): where the JAX package takes a key, these
take the drawn U[0, 1) noise ``u`` itself (fp32, the buffer's shape),
which the engine draws from a `torch.Generator` or takes injected.  Only
`StochasticQuant` reads it; the others take ``u=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import accounting
from repro_torch.comm import flat as cflat
from repro_torch.comm.flat import FlatSpec
from repro_torch.configs.base import CommConfig
from repro_torch.kernels import quantize as kq
from repro_torch.kernels.ref import sign

Payload = Dict[str, torch.Tensor]

#: compressors whose reconstruction is a biased estimator of the input;
#: under ``error_feedback="auto"`` they get EF residuals
BIASED = frozenset({"topk", "signsgd"})


def wants_error_feedback(comm: CommConfig) -> bool:
    """Whether the engine keeps per-client EF residuals: "auto" turns
    EF on exactly for the biased compressors."""
    if comm.lossless:
        return False
    if comm.error_feedback == "auto":
        return comm.compressor in BIASED
    return bool(comm.error_feedback)


def participation_sample(generator: torch.Generator, num_clients: int,
                         num_participants: int) -> torch.Tensor:
    """A uniform sample of S of C clients, as S sorted client ids (int64)
    on the generator's device."""
    perm = torch.randperm(num_clients, generator=generator,
                          device=generator.device)
    return torch.sort(perm[:num_participants]).values


def _zero_stats(like: torch.Tensor, lead=()) -> torch.Tensor:
    return torch.zeros(tuple(lead), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: lossless identity (the wire carries the raw fp32 delta)."""
    cfg: CommConfig
    spec: FlatSpec

    # -- wire format ----------------------------------------------------
    def encode(self, u, flat) -> Payload:
        del u
        return {"x": flat}

    def decode(self, payload: Payload) -> torch.Tensor:
        return payload["x"]

    def header(self) -> cflat.Header:
        """The versioned 24-byte header of this stream's payloads."""
        return cflat.Header(compressor=self.cfg.compressor,
                            total=self.spec.total,
                            quant_block=self.spec.cols,
                            state_dtype=self.cfg.state_dtype)

    def serialize(self, payload: Payload) -> bytes:
        """Canonical little-endian wire bytes of ONE payload: the header,
        then the body; the pad tail is never sent, so ``len`` equals
        `accounting.wire_bytes` for this compressor."""
        return self.header().pack() + self._body(payload)

    def _body(self, payload: Payload) -> bytes:
        x = payload["x"].detach().cpu().numpy().astype("<f4").reshape(-1)
        return x[: self.spec.total].tobytes()

    def stat(self, payload: Payload) -> torch.Tensor:
        """Scalar the server aggregates beside the decoded delta: 0, but
        for `SignSGD`'s scale (its majority vote needs the mean client
        scale)."""
        return _zero_stats(next(iter(payload.values())))

    # -- engine entry points --------------------------------------------
    def roundtrip(self, u, flat) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(decode(encode(flat)), stat)``."""
        payload = self.encode(u, flat)
        return self.decode(payload), self.stat(payload)

    def encode_delta(self, u, theta, start, ef: Optional[torch.Tensor]):
        """One client's uplink over wire-layout buffers: ``delta = (theta
        - start) [+ ef]`` -> round-trip -> new residual.  Returns ``(xhat,
        stat, new_ef)``, ``new_ef`` None when EF is off."""
        delta = theta - start
        if ef is not None:
            delta = delta + ef
        xhat, stat = self.roundtrip(u, delta)
        return xhat, stat, (None if ef is None else delta - xhat)

    def roundtrip_batched(self, u, flat):
        """`roundtrip` over an ``(N, rows, cols)`` stack; ``u`` carries
        the same leading client axis.  Returns ``(xhat, stats)``."""
        return flat, _zero_stats(flat, flat.shape[:1])

    def encode_delta_batched(self, u, theta, start, ef):
        """`encode_delta` over ``(N, rows, cols)`` stacks; ``start`` may
        stay ``(rows, cols)`` (every client trained from one model), and
        ``ef=None`` means EF is off for the whole cohort."""
        delta = theta - start
        if ef is not None:
            delta = delta + ef
        xhat, stats = self.roundtrip_batched(u, delta)
        return xhat, stats, (None if ef is None else delta - xhat)

    def server_combine(self, agg, wstat):
        """Hook on the participation mean of decoded deltas."""
        del wstat
        return agg


@dataclasses.dataclass(frozen=True)
class StochasticQuant(Compressor):
    """int8/int4 stochastic quantization, one fp32 scale per packed row.

    scale = max|row| / qmax, q = floor(x/scale + u), u ~ U[0,1): E[q *
    scale] = x, so the compressor is unbiased (up to the clip of the
    row's largest coordinate).  int4 codes are held in int8; the
    accounting charges 4 bits."""
    bits: int = 8

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def scales(self, flat) -> torch.Tensor:
        """Row scales ``(..., rows, 1)`` of a ``(..., rows, cols)``
        buffer."""
        return torch.amax(torch.abs(flat), dim=-1, keepdim=True) / self.qmax

    def encode(self, u, flat) -> Payload:
        scale = self.scales(flat)
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.clamp(torch.floor(flat / safe + u), -self.qmax, self.qmax)
        return {"q": q.to(torch.int8), "scale": scale}

    def decode(self, payload: Payload) -> torch.Tensor:
        return payload["q"].to(torch.float32) * payload["scale"]

    def _body(self, payload: Payload) -> bytes:
        # [codes][row scales]; int4 packs two two's-complement nibbles
        # per byte, the even coordinate in the low nibble
        q = payload["q"].detach().cpu().numpy().astype(np.int8).reshape(-1)
        q = q[: self.spec.total]
        scales = payload["scale"].detach().cpu().numpy().astype("<f4")
        if self.bits == 8:
            codes = q.tobytes()
        else:
            nib = q.astype(np.uint8) & 0xF
            if nib.size % 2:
                nib = np.append(nib, np.uint8(0))
            codes = (nib[0::2] | (nib[1::2] << 4)).tobytes()
        return codes + scales.reshape(-1).tobytes()

    def roundtrip(self, u, flat):
        xhat = kq.quant_roundtrip_flat(flat, u, self.scales(flat),
                                       qmax=self.qmax)
        return xhat, _zero_stats(xhat)

    def encode_delta(self, u, theta, start, ef):
        if ef is None:
            # EF off (the "auto" default): delta, then the quant kernel
            return super().encode_delta(u, theta, start, ef)
        # the fused uplink kernel: delta + EF + round-trip + residual in
        # one pass (the scales need one reduction over the delta first)
        xhat, resid = kq.uplink_roundtrip_flat(
            theta, start, ef, u, self.scales(theta - start + ef),
            qmax=self.qmax)
        return xhat, _zero_stats(xhat), resid

    def roundtrip_batched(self, u, flat):
        xhat = kq.quant_roundtrip_batched(flat, u, self.scales(flat),
                                          qmax=self.qmax)
        return xhat, _zero_stats(xhat, flat.shape[:1])

    def encode_delta_batched(self, u, theta, start, ef):
        if ef is None:
            return super().encode_delta_batched(u, theta, start, ef)
        xhat, resid = kq.uplink_roundtrip_batched(
            theta, start, ef, u, self.scales(theta - start + ef),
            qmax=self.qmax)
        return xhat, _zero_stats(xhat, theta.shape[:1]), resid


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Magnitude top-k sparsification (biased: "auto" gives it EF).

    Wire format: (int32 index, fp32 value) per surviving coordinate,
    k = ceil(topk_ratio * n_params), capped at the true element count.
    ``encode`` keeps exactly k coordinates, ties broken by the lowest
    index first (as ``lax.top_k``); the round-trips run the threshold
    kernel, which keeps every coordinate whose magnitude reaches the
    k-th largest, all ties at it included, as the JAX package's kernel
    route does."""

    @property
    def k(self) -> int:
        return min(accounting.topk_k(self.cfg, self.spec.total),
                   self.spec.total)

    def encode(self, u, flat) -> Payload:
        del u
        v = flat.reshape(-1)
        # a stable descending sort: equal magnitudes keep index order
        # (torch.topk does not promise any order among ties)
        idx = torch.sort(v.abs(), descending=True, stable=True).indices
        idx = idx[: self.k]
        return {"idx": idx.to(torch.int32), "val": v[idx].to(torch.float32)}

    def decode(self, payload: Payload) -> torch.Tensor:
        val = payload["val"]
        flat = torch.zeros(self.spec.padded, dtype=torch.float32,
                           device=val.device)
        flat[payload["idx"].long()] = val
        return flat.reshape(self.spec.rows, self.spec.cols)

    def header(self) -> cflat.Header:
        return dataclasses.replace(super().header(), aux=self.k)

    def _body(self, payload: Payload) -> bytes:
        idx = payload["idx"].detach().cpu().numpy().astype("<i4")
        val = payload["val"].detach().cpu().numpy().astype("<f4")
        return idx.tobytes() + val.tobytes()

    def thresholds(self, flat) -> torch.Tensor:
        """The k-th largest magnitude of each ``(rows, cols)`` buffer of
        ``flat`` (pad tail included): 0-dim, or ``(N,)`` for a stack.
        Its value does not depend on the order of ties."""
        mags = flat.reshape(flat.shape[:-2] + (-1,)).abs()
        vals = torch.topk(mags, self.k, dim=-1, sorted=True).values
        return vals[..., -1].contiguous()

    def roundtrip(self, u, flat):
        xhat = kq.topk_threshold_flat(flat, self.thresholds(flat))
        return xhat, _zero_stats(xhat)

    def roundtrip_batched(self, u, flat):
        xhat = kq.topk_threshold_batched(flat, self.thresholds(flat))
        return xhat, _zero_stats(xhat, flat.shape[:1])


@dataclasses.dataclass(frozen=True)
class SignSGD(Compressor):
    """1-bit sign compression with one fp32 scale, mean |x| (EF-signSGD;
    biased: "auto" gives it EF).  With ``sign_majority`` the server takes
    the sign of the scale-weighted client vote and rescales it by the
    mean client scale."""

    def scales(self, flat) -> torch.Tensor:
        """mean |x| of each ``(rows, cols)`` buffer of ``flat`` over the
        true coordinates: 0-dim, or ``(N,)`` for a stack."""
        return torch.sum(torch.abs(flat), dim=(-2, -1)) / self.spec.total

    def encode(self, u, flat) -> Payload:
        del u
        return {"sign": sign(flat).to(torch.int8),
                "scale": self.scales(flat)}

    def decode(self, payload: Payload) -> torch.Tensor:
        return (payload["sign"].to(torch.float32)
                * payload["scale"].to(torch.float32))

    def stat(self, payload: Payload) -> torch.Tensor:
        return payload["scale"].to(torch.float32)

    def _body(self, payload: Payload) -> bytes:
        # [packbits(x > 0), MSB-first][fp32 scale]; the bit cannot carry
        # sign(0) = 0, so an exact zero decodes as -scale on a real link
        # (the in-graph round-trip keeps it at 0)
        s = payload["sign"].detach().cpu().numpy().astype(np.int8)
        bits = np.packbits(s.reshape(-1)[: self.spec.total] > 0).tobytes()
        scale = payload["scale"].detach().cpu().numpy().astype("<f4")
        return bits + scale.reshape(1).tobytes()

    def roundtrip(self, u, flat):
        scale = self.scales(flat)
        return kq.sign_roundtrip_flat(flat, scale), scale

    def roundtrip_batched(self, u, flat):
        scale = self.scales(flat)
        return kq.sign_roundtrip_batched(flat, scale), scale

    def server_combine(self, agg, wstat):
        if not self.cfg.sign_majority:
            return agg
        return wstat * sign(agg)


def make_compressor(comm: CommConfig, spec: FlatSpec) -> Compressor:
    c = comm.compressor
    if c == "identity":
        return Compressor(comm, spec)
    if c in ("int8", "int4"):
        return StochasticQuant(comm, spec, bits=int(c[3:]))
    if c == "topk":
        return TopK(comm, spec)
    if c == "signsgd":
        return SignSGD(comm, spec)
    raise ValueError(f"unknown compressor {c!r}")


def make_stream_compressor(comm: CommConfig, stream: str,
                           spec: FlatSpec) -> Compressor:
    """Compressor of one named stream of the round."""
    return make_compressor(comm.stream(stream), spec)
