"""A configuration file of the benchmark (``portbench/configs/<name>.json``,
the public config's keys) read into the sizes the reference and the
weight maker use.  Nothing here comes from the program under test."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: the token table's rows are padded to a multiple of this (the program's
#: input layout: its embedding and head hold the padded vocabulary; the
#: pad rows are never read as tokens and are masked out of the logits)
VOCAB_PAD = 256


@dataclass(frozen=True)
class MLA:
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MoE:
    n_routed_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    n_shared_experts: int
    norm_topk_prob: bool
    capacity_factor: float
    aux_loss_coef: float


@dataclass(frozen=True)
class Conf:
    name: str
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int
    tie_word_embeddings: bool
    rope_theta: float
    rms_norm_eps: float
    scale_emb: float
    residual_scale: float
    dtype: str = "bfloat16"
    mla: Optional[MLA] = None
    moe: Optional[MoE] = None

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD


def from_json(d: dict) -> Conf:
    """The sizes of a configuration file: its top-level public keys, and
    from ``as_run`` what the public config leaves to the modelling code
    (the residual scale of a depth-scaled model, the MoE's capacity and
    aux-loss coefficient)."""
    as_run = d.get("as_run", {})
    mla = moe = None
    if d.get("kv_lora_rank"):
        mla = MLA(d["kv_lora_rank"], d["qk_nope_head_dim"],
                  d["qk_rope_head_dim"], d["v_head_dim"])
    if d.get("n_routed_experts"):
        moe = MoE(d["n_routed_experts"], d["num_experts_per_tok"],
                  d["moe_intermediate_size"], d["n_shared_experts"],
                  bool(d["norm_topk_prob"]), float(as_run["capacity_factor"]),
                  float(as_run["aux_loss_coef"]))
        if d.get("first_k_dense_replace", 0) != 0:
            raise ValueError(f"{d['name']}: a leading dense layer is not "
                             "modelled by this reference")
    if (d.get("rope_scaling") or {}).get("factor", 1) != 1:
        # YaRN at factor 1 is plain RoPE scored by 1/sqrt(head_dim): the
        # frequencies stay and both mscales come to 1
        raise ValueError(f"{d['name']}: RoPE scaling is not modelled by "
                         "this reference")
    heads = d["num_attention_heads"]
    head_dim = (mla.qk_nope_head_dim + mla.qk_rope_head_dim if mla
                else d["hidden_size"] // heads)
    return Conf(name=d["name"], hidden_size=d["hidden_size"],
                num_hidden_layers=d["num_hidden_layers"],
                num_attention_heads=heads,
                num_key_value_heads=d["num_key_value_heads"],
                head_dim=head_dim,
                intermediate_size=0 if moe else d["intermediate_size"],
                vocab_size=d["vocab_size"],
                tie_word_embeddings=bool(d["tie_word_embeddings"]),
                rope_theta=float(d["rope_theta"]),
                rms_norm_eps=float(d["rms_norm_eps"]),
                scale_emb=float(d.get("scale_emb", 1.0)),
                residual_scale=float(as_run.get("residual_scale", 1.0)),
                dtype=d["torch_dtype"], mla=mla, moe=moe)
