"""The entry point and its arguments for every (architecture x input
shape) combination on one card: the twin of the JAX package's
``launch/api.py``.

The JAX version returns ``ShapeDtypeStruct`` stand-ins and shardings so
that the dry run can lower and compile the production meshes on CPU
placeholders.  One card has no shardings: a `Bundle` holds the entry
point and ``make_args``, which builds its arguments when called inside
the caller's ``FakeTensorMode`` (`repro_torch.launch.dryrun.trace`), so
that nothing is allocated and nothing runs.  The trace device is the
CPU's (`TRACE_DEVICE`): a fake tensor has no storage on either device,
every kernel entry point takes its shape-only path (`kernels/cost.py`)
whatever the device, and a CUDA fake tensor cannot be made on a machine
without a card.

The shapes are the JAX package's: ``train_4k`` trains at seq 4096 and a
global batch of 256 (each client ``max(256 // C, 1)``); ``--reduced``
configs run d_model 128 at seq 32, batch 16 (serving: 4 x 64);
``long_500k`` serves global-attention patterns with
``long_mode_swa_only``.  `resolve_fed` gives the JAX production mesh's
cohort: its ``(16, 16)`` 1-pod mesh lays clients over ``data``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, FedConfig, ModelConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models import transformer as T

FULL_ATTENTION_ARCHS = {
    "qwen3-moe-235b-a22b", "minicpm-2b", "qwen3-14b",
    "deepseek-v2-lite-16b", "qwen2-vl-2b", "chatglm3-6b",
}
ENCODER_ONLY_ARCHS = {"hubert-xlarge"}

#: clients of a parallel arch: the JAX production 1-pod mesh, (16, 16)
#: over (data, model), lays them over ``data``
NUM_CLIENTS = 16
#: clients of a sequential arch (the JAX ``resolve_fed``'s)
SEQUENTIAL_CLIENTS = 8
#: the device of a trace's fake tensors (module docstring)
TRACE_DEVICE = "cpu"


def applicable(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    """Shape/arch skip rules (the JAX package's)."""
    shape = INPUT_SHAPES[shape_name]
    if arch_id in ENCODER_ONLY_ARCHS and shape.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape_name == "long_500k" and arch_id in FULL_ATTENTION_ARCHS:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic mixing")
    return True, ""


@dataclass
class Bundle:
    """Everything the dry run needs for one combination: ``fn(*args)``
    with ``args = make_args()``, built inside the caller's fake mode."""
    fn: Callable
    make_args: Callable[[], tuple]
    meta: Dict[str, Any]


def resolve_fed(arch_id: str, *, num_clients: int = NUM_CLIENTS,
                local_iters: int = 10) -> FedConfig:
    """The arch's `FedConfig` as the JAX ``resolve_fed`` gives it:
    ``num_clients`` on the parallel strategy, `SEQUENTIAL_CLIENTS` on the
    sequential one (each client then has the whole device), where the
    per-client EMAs are off unless the arch file says otherwise."""
    over = dict(configs.get_fed_overrides(arch_id))
    strategy = over.pop("strategy", "parallel")
    if strategy != "parallel":
        num_clients = SEQUENTIAL_CLIENTS
    persistent = over.pop("persistent_client_state",
                          strategy != "sequential")
    return FedConfig(num_clients=num_clients, local_iters=local_iters,
                     optimizer="fed_sophia", strategy=strategy,
                     persistent_client_state=persistent,
                     tau=10, **over)


def _apply_overrides(cfg: ModelConfig, over: Optional[dict]) -> ModelConfig:
    if not over:
        return cfg
    typed = {}
    for k, v in over.items():
        cur = getattr(cfg, k)
        if isinstance(v, str) and cur is not None:
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, (int, float, str)):
                v = type(cur)(v)
        typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _typed_fed(fed: FedConfig, over: Optional[dict]) -> FedConfig:
    if not over:
        return fed
    typed = {k: (type(getattr(fed, k))(v)
                 if isinstance(v, str) and not isinstance(
                     getattr(fed, k), (bool, str)) else v)
             for k, v in over.items()}
    return dataclasses.replace(fed, **typed)


def _batch(cfg: ModelConfig, lead: tuple, seq: int, device,
           labels: bool = False) -> dict:
    """Zero token ids (an embedding-input config: zero embeddings in its
    dtype), and with ``labels`` the zero labels: shapes are what a trace
    reads."""
    out = {}
    if cfg.embedding_inputs:
        out["embeds"] = torch.zeros(lead + (seq, cfg.d_model),
                                    dtype=T.param_dtype(cfg), device=device)
    else:
        out["tokens"] = torch.zeros(lead + (seq,), dtype=torch.int64,
                                    device=device)
    if labels:
        out["labels"] = torch.zeros(lead + (seq,), dtype=torch.int64,
                                    device=device)
    return out


def round_bundle(engine: FedEngine, batch_shape: tuple, seq: int,
                 packed_state: bool, meta: dict) -> Bundle:
    """`FedEngine.round` over a state made as the trainer makes it (the
    weights drawn, the round-0 state, packed between rounds when
    ``packed_state``) and zero batches of ``batch_shape`` (clients,
    per-client batch) on the engine's device."""
    cfg, device = engine.task.cfg, engine.device

    def make_args():
        gen = torch.Generator(device=device).manual_seed(0)
        state = engine.init(gen)
        if packed_state:
            state = engine.pack_state(state)
        return state, _batch(cfg, batch_shape, seq, device, labels=True), gen

    def train_round(state, batches, generator):
        return engine.round(state, batches, generator=generator)

    return Bundle(train_round, make_args, meta)


def build_train(arch_id: str, *, reduced: bool = False,
                local_iters: int = 10, optimizer: str = "fed_sophia",
                cfg_overrides: Optional[dict] = None,
                fed_overrides: Optional[dict] = None,
                packed_state: bool = False) -> Bundle:
    """One federated round of ``train_4k`` (``entry``: train_round)."""
    cfg = _apply_overrides(configs.get_model_config(arch_id), cfg_overrides)
    shape = INPUT_SHAPES["train_4k"]
    seq, gbatch = shape.seq_len, shape.global_batch
    if reduced:
        cfg = cfg.reduced(d_model=128)
        seq, gbatch = 32, 16
    fed = resolve_fed(arch_id, local_iters=local_iters)
    if optimizer != "fed_sophia":
        fed = dataclasses.replace(fed, optimizer=optimizer)
    fed = _typed_fed(fed, fed_overrides)
    engine = FedEngine(T.LMTask(cfg), fed, device=TRACE_DEVICE)
    C = fed.num_clients
    b = max(gbatch // C, 1)
    meta = dict(arch=arch_id, shape="train_4k", entry="train_round",
                num_clients=C, per_client_batch=b, strategy=fed.strategy,
                seq=seq, cfg=cfg, fed=fed, packed_state=packed_state)
    return round_bundle(engine, (C, b), seq, packed_state, meta)


def build_train_cli(argv) -> Bundle:
    """One round of the trainer's CLI (`repro_torch.launch.train`) on
    ``argv``: its config, its cohort and batch, its packed residency
    (``--tree-state`` keeps the dict) and its depth cut, on the trace
    device (the CLI's ``--device`` is not read)."""
    from repro_torch.launch import train
    args = train.build_parser().parse_args(argv)
    cfg = train.model_config(args)
    fed = train.fed_config(args)
    engine = FedEngine(T.LMTask(cfg), fed, device=TRACE_DEVICE)
    meta = dict(arch=args.arch, shape="cli", entry="train_round",
                num_clients=fed.num_clients, per_client_batch=args.batch,
                strategy=fed.strategy, seq=args.seq, cfg=cfg, fed=fed,
                packed_state=not args.tree_state)
    return round_bundle(engine, (fed.num_clients, args.batch), args.seq,
                        not args.tree_state, meta)


def _serve_cfg(arch_id: str, shape_name: str, reduced: bool,
               cfg_overrides: Optional[dict] = None) -> ModelConfig:
    cfg = _apply_overrides(configs.get_model_config(arch_id), cfg_overrides)
    if reduced:
        cfg = cfg.reduced(d_model=128)
    if shape_name == "long_500k" and "global" in cfg.block_pattern:
        cfg = dataclasses.replace(cfg, long_mode_swa_only=True)
    return cfg


def _weights(cfg: ModelConfig):
    return T.init_lm(torch.Generator(device=TRACE_DEVICE).manual_seed(0),
                     cfg)


def build_prefill(arch_id: str, *, reduced: bool = False,
                  cfg_overrides: Optional[dict] = None) -> Bundle:
    """The prompt's forward with its caches (``entry``: serve_prefill)."""
    cfg = _serve_cfg(arch_id, "prefill_32k", reduced, cfg_overrides)
    shape = INPUT_SHAPES["prefill_32k"]
    B, seq = shape.global_batch, shape.seq_len
    if reduced:
        B, seq = 4, 64

    def make_args():
        return _weights(cfg), _batch(cfg, (B,), seq, TRACE_DEVICE)

    def prefill(params, batch):
        with torch.no_grad():
            logits, cache, _ = T.forward(params, cfg, batch,
                                         want_cache=True, remat=False)
        return logits, cache

    meta = dict(arch=arch_id, shape="prefill_32k", entry="serve_prefill",
                batch=B, seq=seq, cfg=cfg)
    return Bundle(prefill, make_args, meta)


def build_decode(arch_id: str, shape_name: str, *, reduced: bool = False,
                 cfg_overrides: Optional[dict] = None) -> Bundle:
    """One decode step over a cache of the shape's length (``entry``:
    serve_step)."""
    cfg = _serve_cfg(arch_id, shape_name, reduced, cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    B, seq = shape.global_batch, shape.seq_len
    if reduced:
        B, seq = 4, 64

    def make_args():
        return (_weights(cfg), _batch(cfg, (B,), 1, TRACE_DEVICE),
                T.init_cache(cfg, B, seq, device=TRACE_DEVICE), 0)

    def step(params, batch, cache, pos):
        with torch.no_grad():
            return T.decode_step(params, cfg, batch, cache, pos)

    meta = dict(arch=arch_id, shape=shape_name, entry="serve_step",
                batch=B, cache_len=seq, cfg=cfg)
    return Bundle(step, make_args, meta)


def build(arch_id: str, shape_name: str, *, reduced: bool = False,
          **kw) -> Bundle:
    ok, reason = applicable(arch_id, shape_name)
    if not ok:
        raise ValueError(f"skip {arch_id} x {shape_name}: {reason}")
    kind = INPUT_SHAPES[shape_name].kind
    if kind == "train":
        return build_train(arch_id, reduced=reduced, **kw)
    cfg_overrides = kw.pop("cfg_overrides", None)
    if kind == "prefill":
        return build_prefill(arch_id, reduced=reduced,
                             cfg_overrides=cfg_overrides)
    return build_decode(arch_id, shape_name, reduced=reduced,
                        cfg_overrides=cfg_overrides)
