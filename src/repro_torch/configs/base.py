"""Config dataclasses: the port's own copy of the model-zoo configs
(`ModelConfig`, `MoEConfig`, `MLAConfig`) and of `FedConfig` with its
nested `CommConfig`, `SchedConfig`, `RobustConfig` and `ObsConfig`,
and the cost tools' `ShapeConfig`, `INPUT_SHAPES` and `RunConfig`,
with the field names and defaults of the JAX package's
``configs/base.py``.  `repro_torch.core.fed.FedEngine` runs every
setting the JAX engine runs and raises `ValueError` for unknown ones;
`repro_torch.models.transformer` runs every arch of the model zoo.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # layer stacking: pattern of block kinds, tiled over num_layers.
    #   attn | local | global | rec (RG-LRU) | m (mLSTM) | s (sLSTM)
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention options
    causal: bool = True
    qk_norm: bool = False
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    window: Optional[int] = None      # sliding-window size for 'local' blocks
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0           # chatglm applies rotary to half the dims
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    mla: Optional[MLAConfig] = None
    # ffn
    ffn_kind: str = "swiglu"          # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    # recurrent blocks
    lru_width: int = 0                # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4               # temporal conv in recurrent blocks
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    # perf knobs (§Perf hillclimb; defaults = paper-faithful baseline)
    pad_attn_heads: int = 0           # pad q-heads to this count with zero
    # wq cols / wo rows (mathematically exact — zero heads contribute 0 and
    # receive 0 gradient). Aligns num_heads to the model axis so attention
    # shards on heads instead of splitting head_dim (which turns every
    # score einsum into a partial-sum all-reduce).
    slstm_unroll: int = 1             # scan unroll: weights read once/U steps
    attn_chunk_threshold: int = 2048  # seq len above which attention uses
    # the online-softmax KV-chunked path (0 = always chunked; big = dense)
    attn_kv_chunk: int = 1024         # KV tile for the chunked path
    train_remat: bool = True          # per-block activation checkpointing
    scan_compute_dtype: str = "float32"   # mLSTM chunk-scan operand dtype:
    #   "bfloat16" keeps q/k/v bf16 across the sharding boundary (halves the
    #   per-chunk model-axis all-gather bytes); accumulation stays fp32.
    # misc
    residual_scale: float = 1.0       # minicpm depth scaling
    scale_emb: float = 1.0
    tie_embeddings: bool = True
    post_norm: bool = False           # gemma2 post-block norms
    dtype: str = "float32"
    # serving: replace 'global' with 'local' blocks for long-context mode
    long_mode_swa_only: bool = False
    # frontend stubs (audio/vlm): inputs are embeddings, not token ids
    embedding_inputs: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def vocab_padded(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def pattern_reps(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def pattern_remainder(self) -> Tuple[str, ...]:
        rem = self.num_layers % len(self.block_pattern)
        return tuple(self.block_pattern[:rem])

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims."""
        num_layers = max(num_layers, len(self.block_pattern))
        num_layers = (num_layers // len(self.block_pattern)) * len(self.block_pattern)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        if heads % kv:
            kv = 1
        changes = dict(
            num_layers=num_layers, d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=d_model // heads,
            d_ff=max(2 * d_model, 64), vocab_size=min(self.vocab_size, 512),
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            window=min(self.window, 64) if self.window else None,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=max(d_model // 2, 32),
                num_shared=min(self.moe.num_shared, 1),
                d_ff_shared=max(d_model // 2, 32) if self.moe.num_shared else 0)
        if self.mla is not None:
            changes["mla"] = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                                       qk_rope_head_dim=16, v_head_dim=32)
            changes["head_dim"] = 32
        if self.mrope_sections is not None:
            hd = changes["head_dim"]
            changes["mrope_sections"] = (hd // 2 - 2 * (hd // 8), hd // 8, hd // 8)
        return dataclasses.replace(self, **changes)


#: The named wire streams of a federated round.  Every stream shares the
#: flattened coordinate order of `repro_torch.comm.flat` and gets its own
#: compressor and error-feedback policy via `CommConfig.stream(name)`.
COMM_STREAMS = ("uplink", "downlink", "hessian")


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
    # kept for parity with the JAX config; on the card the quantize
    # kernels always run, on the CPU their plain versions
    use_pallas: bool = False
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

    def stream(self, name: str) -> "CommConfig":
        """Per-stream view: this config with ``compressor`` /
        ``error_feedback`` / packing geometry (``quant_block``,
        ``topk_ratio``) resolved for the named stream, so the same
        compressor factory and accounting serve every stream."""
        if name == "uplink":
            return self
        if name == "downlink":
            return dataclasses.replace(
                self, compressor=self.downlink_compressor,
                error_feedback=self.downlink_error_feedback,
                quant_block=self.downlink_quant_block or self.quant_block,
                topk_ratio=self.downlink_topk_ratio or self.topk_ratio)
        if name == "hessian":
            c = self.hessian_compressor
            return dataclasses.replace(
                self, compressor="identity" if c == "off" else c,
                error_feedback=False,
                quant_block=self.hessian_quant_block or self.quant_block,
                topk_ratio=self.hessian_topk_ratio or self.topk_ratio)
        raise ValueError(f"unknown stream {name!r} (want {COMM_STREAMS})")

    def num_participants(self, num_clients: int) -> int:
        s = int(round(self.participation * num_clients))
        return max(1, min(num_clients, s))


#: Round disciplines of the virtual-time scheduler (repro_torch.sched).
SCHED_DISCIPLINES = ("sync", "semisync", "async")

#: Latency profiles of the virtual-time scheduler (repro_torch.sched).
LATENCY_PROFILES = ("uniform", "straggler", "lognormal")


@dataclass(frozen=True)
class SchedConfig:
    """Virtual-time round scheduling, driven by
    `repro_torch.sched.VirtualScheduler`; the engine reads only
    ``dispatch_chunk`` (client-batched steps of more clients than that
    run as chunks of that many, then one tail)."""
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


#: Robust server-side aggregators (repro_torch.robust): "mean" is the
#: plain weighted-mean path; the others replace the combine of the
#: (K, rows, cols) arrival stack.
AGGREGATORS = ("mean", "trimmed_mean", "coordinate_median", "norm_clip")

#: Byzantine wire attacks of the fault-injection layer
#: (repro_torch.robust): each transforms a malicious client's packed
#: uplink buffer, keeping its shape and dtype.
ATTACKS = ("none", "sign_flip", "scale", "random_wire")


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

    @property
    def adversarial(self) -> bool:
        """Any fault injection active (attacks, label noise or churn)."""
        return ((self.attack != "none" and self.attack_fraction > 0.0)
                or self.label_noise_fraction > 0.0
                or self.dropout_prob > 0.0)


@dataclass(frozen=True)
class ObsConfig:
    """Structured telemetry: ``trace`` (per-dispatch trace contexts of
    the scheduler), ``probes`` (the Sophia health scalars of
    `repro_torch.obs.probes` in every round's metrics and event
    record), ``flush_every`` (rounds per `obs.MetricsAccumulator`
    flush, the one host copy of a window's metrics in the trainer's
    obs loop) and ``ring_capacity`` (records `obs.RunRecorder` keeps
    in memory)."""
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


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the cost tools (`repro_torch.launch.api`)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    fed: FedConfig = field(default_factory=FedConfig)
    seed: int = 0
