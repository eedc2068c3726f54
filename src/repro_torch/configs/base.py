"""Federated runtime config dataclasses: the port's own copy of
`FedConfig` and its nested `CommConfig`, `SchedConfig`, `RobustConfig`
and `ObsConfig`, with the field names and defaults of the JAX
package's ``configs/base.py``.

The engine of this slice runs only the direct path (lossless identity
uplink, full participation, no extra streams); `repro_torch.core.fed`
raises `NotImplementedError` for every other setting, naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class CommConfig:
    """Client<->server communication model: three named wire streams
    (uplink model delta, downlink broadcast, hessian-EMA), each with its
    own compressor.  The default — lossless identity uplink/downlink,
    hessian off, full participation — is the direct client-mean path."""
    compressor: str = "identity"      # identity | int8 | int4 | topk | signsgd
    error_feedback: object = "auto"   # "auto" | True | False
    participation: float = 1.0        # fraction S/C of clients sampled/round
    topk_ratio: float = 0.01          # k = ceil(ratio * n_params)
    sign_majority: bool = False       # signsgd: server majority vote on signs
    quant_block: int = 1024           # elements per quantization scale group
    use_pallas: bool = False          # fused quantize/dequantize kernels
    seed: int = 0                     # participation-sampling salt
    # downlink stream (server -> client broadcast)
    downlink_compressor: str = "identity"
    downlink_error_feedback: object = "auto"   # "auto" | True | False
    # hessian stream (Sophia h-EMA uplink + averaged broadcast); "off"
    # disables it
    hessian_compressor: str = "off"
    # storage dtype of resident wire-layout state
    state_dtype: str = "float32"      # float32 | bfloat16 | float8_e4m3fn | float8_e5m2
    moment_dtype: str = ""            # "" -> inherit state_dtype
    hessian_dtype: str = ""           # "" -> inherit state_dtype
    # per-stream packing geometry overrides (0 / 0.0 = inherit)
    downlink_quant_block: int = 0
    downlink_topk_ratio: float = 0.0
    hessian_quant_block: int = 0
    hessian_topk_ratio: float = 0.0

    @property
    def lossless(self) -> bool:
        return self.compressor == "identity"

    @property
    def downlink_enabled(self) -> bool:
        return self.downlink_compressor != "identity"

    @property
    def hessian_enabled(self) -> bool:
        return self.hessian_compressor != "off"

    @property
    def multi_stream(self) -> bool:
        """Any stream beyond the uplink is active."""
        return self.downlink_enabled or self.hessian_enabled

    def num_participants(self, num_clients: int) -> int:
        s = int(round(self.participation * num_clients))
        return max(1, min(num_clients, s))


@dataclass(frozen=True)
class SchedConfig:
    """Virtual-time round scheduling.  Consumed by the scheduler, not by
    the engine; the scheduler is not ported yet."""
    discipline: str = "sync"          # sync | semisync | async
    buffer_size: int = 0              # semisync: arrivals per aggregation
    staleness_power: float = 0.5      # arrival weight (1+tau)^-p
    latency_profile: str = "uniform"  # uniform | straggler | lognormal
    compute_s: float = 1.0            # base seconds per local iteration
    bandwidth_bps: float = 1e8        # base link speed, bits/second
    straggler_frac: float = 0.25      # straggler: fraction of slow clients
    straggler_slowdown: float = 10.0  # straggler: slow-client multiplier
    lognormal_sigma: float = 0.75     # lognormal: client-speed spread
    seed: int = 0                     # latency-sampling salt
    dispatch_chunk: int = 0           # 0 -> unchunked


@dataclass(frozen=True)
class RobustConfig:
    """Adversarial-fleet knobs: robust aggregation, byzantine faults and
    churn.  The default is the plain mean path."""
    aggregator: str = "mean"          # mean | trimmed_mean | coordinate_median | norm_clip
    trim_fraction: float = 0.0        # per-side per-coordinate trim (trimmed_mean)
    clip_norm: float = 0.0            # max L2 norm per arrival (norm_clip; 0 = off)
    attack: str = "none"              # none | sign_flip | scale | random_wire
    attack_fraction: float = 0.0      # fraction of clients byzantine
    attack_scale: float = 10.0        # multiplier for the "scale" attack
    label_noise_fraction: float = 0.0 # fraction of clients with noisy labels
    label_noise_rate: float = 0.5     # P(label resampled) for noisy clients
    dropout_prob: float = 0.0         # per-dispatch client dropout probability
    rejoin_delay_s: float = 0.0       # extra virtual seconds before a dropped
    #                                   client's update is delivered
    seed: int = 0                     # fault-injection salt


@dataclass(frozen=True)
class ObsConfig:
    """Structured telemetry.  ``probes`` (device-side Sophia health
    metrics) is not ported yet."""
    probes: bool = False
    trace: bool = False
    flush_every: int = 10
    ring_capacity: int = 1024


@dataclass(frozen=True)
class FedConfig:
    """Federated runtime configuration (Alg. 1 hyper-parameters)."""
    num_clients: int = 32
    local_iters: int = 10             # J
    optimizer: str = "fed_sophia"     # fed_sophia | fedavg | done | fedadam | fedyogi
    strategy: str = "parallel"        # parallel (client batch dim) | sequential (client loop)
    lr: float = 3e-3                  # eta
    beta1: float = 0.9
    beta2: float = 0.95
    rho: float = 0.04                 # clip threshold
    eps: float = 1e-12
    weight_decay: float = 1e-4        # lambda
    tau: int = 10                     # hessian refresh period
    hessian_every_unit: str = "step"  # step | round (paper-literal)
    # persistent per-client (m, h) across rounds (Alg. 1 line 2); False =
    # fresh EMAs every round, tau then counts within-round steps
    persistent_client_state: bool = True
    # server-side optimizer params (FedAdam/FedYogi)
    server_lr: float = 0.1
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_eps: float = 1e-3
    # DONE baseline
    done_richardson_iters: int = 20
    done_damping: float = 10.0
    # split each local batch into N micro-batches and average the grads
    grad_microbatches: int = 1
    # schedule: const | cosine | wsd
    schedule: str = "const"
    warmup_rounds: int = 0
    total_rounds: int = 100
    decay_frac: float = 0.1           # WSD decay tail fraction
    # kept for parity with the JAX config; on the card the fused kernel
    # always runs, on the CPU its plain version
    use_pallas: bool = False
    comm: CommConfig = field(default_factory=CommConfig)
    sched: SchedConfig = field(default_factory=SchedConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    robust: RobustConfig = field(default_factory=RobustConfig)
