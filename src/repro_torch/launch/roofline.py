"""Roofline terms of a traced program on one card, and the useful work of
each entry point: the twin of the JAX package's ``launch/roofline.py``.

  compute term    = sum over dtypes of the traced FLOPs / the dtype's peak
  memory term     = traced bytes / HBM rate
  collective term = 0 on one card

The peaks are the card's own, from NVIDIA's data sheet for the H100 SXM
(NVIDIA H100 80GB HBM3, 700.00 W): HBM 3.35e12 B/s, dense bf16 (and
fp16) on the tensor cores 989.4e12 FLOP/s, fp32 outside them 67e12
FLOP/s.  The port turns TF32 off, so an fp32 GEMM runs at the fp32 peak:
priced at the bf16 peak it would read 15x too fast.  The traced FLOPs
and bytes come from `repro_torch.launch.op_cost`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

from repro_torch.models import transformer as T

#: NVIDIA H100 80GB HBM3, 700.00 W (data sheet): HBM bytes per second
HBM_BYTES_PER_S = 3.35e12
#: NVIDIA H100 80GB HBM3, 700.00 W (data sheet): dense FLOP/s by dtype;
#: any other dtype is priced at the fp32 peak
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 67e12}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def compute_seconds(flops: Union[float, Mapping[str, float]]) -> float:
    """Seconds at the card's peaks: ``flops`` by dtype name, or one number
    (the JAX record's meaning: dense bf16)."""
    if not isinstance(flops, Mapping):
        flops = {"bfloat16": float(flops)}
    return sum(f / peak_flops(d) for d, f in flops.items())


def collective_bytes(hlo_text: str = "") -> Dict[str, float]:
    """Bytes moved between devices, by collective kind: the JAX version
    parses them out of partitioned HLO text.  The port runs on one card
    and lowers no HLO, so there is nothing to parse: every kind is 0."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    out["total"] = 0.0
    return out


def roofline_terms(flops: Union[float, Mapping[str, float]],
                   bytes_: float, coll_bytes: float = 0.0
                   ) -> Dict[str, Union[float, str]]:
    """The three terms (seconds) and the bottleneck, ``compute`` or
    ``memory``; ``collective_s`` is 0 on one card and is kept so the
    records share the JAX keys."""
    if coll_bytes:
        raise ValueError("one card moves no collective bytes")
    terms: Dict[str, Union[float, str]] = {
        "compute_s": compute_seconds(flops),
        "memory_s": bytes_ / HBM_BYTES_PER_S,
        "collective_s": 0.0,
    }
    terms["bottleneck"] = ("compute" if terms["compute_s"]
                           >= terms["memory_s"] else "memory")
    return terms


# --------------------------------------------------------------------------
# MODEL_FLOPS (useful work) per entry point
# --------------------------------------------------------------------------

def count_params(cfg) -> Dict[str, float]:
    """Total and active (MoE top-k) parameter counts from shapes alone:
    the weights drawn on the meta device."""
    params = T.init_lm(T._ShapeOnly(), cfg)
    total = expert = 0
    for path, leaf in params.items():
        n = leaf.numel()
        total += n
        if cfg.moe is not None and "ffn" in path and "shared" not in path \
                and path.split("/")[-1] in ("w_gate", "w_up", "w_down"):
            expert += n
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": float(total), "active": float(active)}


def model_flops(cfg, shape_name: str, *, local_iters: int = 10) -> float:
    from repro_torch.configs.base import INPUT_SHAPES
    shape = INPUT_SHAPES[shape_name]
    n = count_params(cfg)["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * local_iters
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token each
