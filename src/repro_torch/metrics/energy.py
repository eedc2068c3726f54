"""Energy / carbon-footprint model of the paper (Eq. 13-14, Table II).

E_total(k) = E_c(k) + E_t(k)
  E_c: per-local-iteration compute energy summed over rounds
  E_t: transmission energy = bits(model) / R * P_t per round
  R   = B log2(1 + P_t / (d * B * N0))      (Shannon, paper §V-A)

Paper constants: P_t = 100 mW, B = 2 MHz, N0 = 1e-9 W/Hz, 100x100 m area,
uniform client-PS distance; 32-bit parameters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

CARBON_KG_PER_MJ = 0.12 / 3.6   # ~0.12 kg-CO2/kWh grid intensity


@dataclass(frozen=True)
class ChannelModel:
    p_t: float = 0.1            # W
    bandwidth: float = 2e6      # Hz
    n0: float = 1e-9            # W/Hz
    distance: float = 50.0      # m (uniform within 100x100 area)
    bits_per_param: int = 32

    def rate(self) -> float:
        snr = self.p_t / (self.distance * self.bandwidth * self.n0)
        return self.bandwidth * math.log2(1.0 + snr)

    def tx_energy_per_round(self, num_params: int) -> float:
        """Joules to upload one model vector (Eq. 14 E_t term)."""
        bits = num_params * self.bits_per_param
        return bits / self.rate() * self.p_t


def tx_energy_joules(n_bytes: int,
                     channel: ChannelModel = ChannelModel()) -> float:
    """Eq. 14's transmission-energy term over EXACT wire bytes.

    ``tx_energy_per_round`` prices a raw 32-bit parameter vector; the
    comm layer's compressed streams transmit far fewer bytes, so
    per-round telemetry (docs/observability.md) prices the accounting
    model's exact per-stream byte counts instead:

        E_t = 8 * n_bytes / R * P_t,   R = B log2(1 + P_t/(d B N0))
    """
    return 8.0 * n_bytes / channel.rate() * channel.p_t


@dataclass(frozen=True)
class ComputeModel:
    """Per-local-iteration energy: FLOPs / (device FLOP/s) * device power."""
    device_flops: float = 1e12
    device_power: float = 10.0   # W (edge device)

    def energy_per_iteration(self, flops_per_iter: float) -> float:
        return flops_per_iter / self.device_flops * self.device_power


def round_energy(num_params: int, flops_per_iter: float, local_iters: int,
                 hessian_iters: int = 0, hessian_flop_mult: float = 1.0,
                 channel: ChannelModel = ChannelModel(),
                 compute: ComputeModel = ComputeModel()) -> dict:
    """Energy per communication round per client, in Joules.

    hessian_iters: local iterations that additionally run the GNB
    estimator (one extra fwd+bwd -> hessian_flop_mult ~ 1.0 of a step).
    """
    e_c = compute.energy_per_iteration(flops_per_iter) * (
        local_iters + hessian_iters * hessian_flop_mult)
    e_t = channel.tx_energy_per_round(num_params)
    return {"compute_J": e_c, "comm_J": e_t, "total_J": e_c + e_t}


def footprint_kg_co2(total_joules: float) -> float:
    return total_joules / 1e6 * CARBON_KG_PER_MJ
