"""The decoder: the arch of every configuration file without an
``"arch"`` key (`portbench.cells.DEFAULT_ARCH`), the benchmark's two
language models.  Its sizes from the configuration file, its weight
schema, the parameters a token's products take, and its plain float32
reference: the decoder's forward pass, loss and GNB label sampling,
written from the published descriptions (MiniCPM, arXiv:2404.06395;
DeepSeek-V2, arXiv:2405.04434).  It imports nothing of the program; it
reads the weights dict the benchmark made (`schema` names its keys).

Per layer: ``x += r * attn(rms(x))``, then ``x += r * ffn(rms(x))``,
with ``r`` the residual scale; the input is the token's row of the table
times ``scale_emb``; the logits are ``rms(x) @ head`` over the real
vocabulary.  Attention is causal softmax attention with RoPE (the
rotated half split in two halves) on every head dimension, or for MLA
on the 64 rope dimensions of the query and of the one shared rope key,
the other key and value dimensions up-projected from the normed latent.
The MoE FFN routes each token to its top-k experts by the router's
softmax (ties to the lower index), renormalises the k gates, keeps at
most ``capacity`` tokens a sequence an expert (choices taken rank by
rank, each rank along the sequence; a choice past it is dropped), adds
the shared experts, and contributes the Switch load-balance loss.

Float32 products run with TF32 off: the caller sets
``torch.backends.cuda.matmul.allow_tf32`` (`layers.no_tf32`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.inits import DENSE, EMBED, ONES, Schema
from portbench.reference.layers import attend, rms, rope

Params = Dict[str, torch.Tensor]

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


def schema(conf: Conf) -> Schema:
    """key -> (shape, dtype, init) of every leaf, in the program's input
    layout: a flat dict keyed by ``/``-joined paths, every block's leaves
    stacked on a leading layer axis under ``blocks_0/``
    (``blocks_0/mixer/wq`` is ``(L, D, H*hd)``), the token table
    ``embed`` of the padded vocabulary, ``lm_head`` when the head is
    untied; the MoE router in float32, everything else in the
    configuration's ``torch_dtype``."""
    bf, f32 = getattr(torch, conf.dtype), torch.float32
    D, L, H = conf.hidden_size, conf.num_hidden_layers, conf.num_attention_heads
    Vp = conf.vocab_padded
    out: Schema = {"embed": ((Vp, D), bf, EMBED),
                   "final_norm": ((D,), bf, ONES)}
    if not conf.tie_word_embeddings:
        out["lm_head"] = ((D, Vp), bf, DENSE)
    blk = {"ln1": ((L, D), bf, ONES), "ln2": ((L, D), bf, ONES)}
    if conf.mla is not None:
        m = conf.mla
        blk.update({
            "mixer/wq": ((L, D, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                         bf, DENSE),
            "mixer/w_dkv": ((L, D, m.kv_lora_rank + m.qk_rope_head_dim), bf,
                            DENSE),
            "mixer/kv_norm": ((L, m.kv_lora_rank), bf, ONES),
            "mixer/w_ukv": ((L, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim)), bf,
                            DENSE),
            "mixer/wo": ((L, H * m.v_head_dim, D), bf, DENSE)})
    else:
        hd, K = conf.head_dim, conf.num_key_value_heads
        blk.update({"mixer/wq": ((L, D, H * hd), bf, DENSE),
                    "mixer/wk": ((L, D, K * hd), bf, DENSE),
                    "mixer/wv": ((L, D, K * hd), bf, DENSE),
                    "mixer/wo": ((L, H * hd, D), bf, DENSE)})
    if conf.moe is not None:
        mo = conf.moe
        E, F = mo.n_routed_experts, mo.moe_intermediate_size
        Fs = mo.n_shared_experts * mo.moe_intermediate_size
        blk.update({"ffn/router": ((L, D, E), f32, DENSE),
                    "ffn/w_gate": ((L, E, D, F), bf, DENSE),
                    "ffn/w_up": ((L, E, D, F), bf, DENSE),
                    "ffn/w_down": ((L, E, F, D), bf, DENSE)})
        if Fs:
            blk.update({"ffn/shared/w_gate": ((L, D, Fs), bf, DENSE),
                        "ffn/shared/w_up": ((L, D, Fs), bf, DENSE),
                        "ffn/shared/w_down": ((L, Fs, D), bf, DENSE)})
    else:
        F = conf.intermediate_size
        blk.update({"ffn/w_gate": ((L, D, F), bf, DENSE),
                    "ffn/w_up": ((L, D, F), bf, DENSE),
                    "ffn/w_down": ((L, F, D), bf, DENSE)})
    out.update({f"blocks_0/{k}": v for k, v in blk.items()})
    return out


def active_params(conf: Conf) -> float:
    """Parameters that take part in a token's products: every weight but
    the routed experts' unchosen share (top_k of n_routed_experts kept)
    and, for an untied head, the input token table (a lookup, no
    product).  A tied table counts once, as the head."""
    total = routed = 0
    for key, (shape, _, _) in schema(conf).items():
        n = math.prod(shape)
        if key == "embed" and not conf.tie_word_embeddings:
            continue
        total += n
        if conf.moe is not None and key in ("blocks_0/ffn/w_gate",
                                            "blocks_0/ffn/w_up",
                                            "blocks_0/ffn/w_down"):
            routed += n
    if routed:
        mo = conf.moe
        total -= routed * (1 - mo.num_experts_per_tok / mo.n_routed_experts)
    return float(total)


class Model:
    """The reference LM of one configuration over one client's weights
    (float32 leaves keyed as `schema` names them)."""

    def __init__(self, conf: Conf):
        self.c = conf

    @staticmethod
    def lin(x, w):
        return x @ w

    def swiglu(self, x, wg, wu, wd):
        return self.lin(F.silu(self.lin(x, wg)) * self.lin(x, wu), wd)

    def attention(self, p: Params, l: int, h: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, S, _ = h.shape
        H = c.num_attention_heads
        if c.mla is None:
            hd, K = c.head_dim, c.num_key_value_heads
            q = self.lin(h, p["blocks_0/mixer/wq"][l]).view(B, S, H, hd)
            k = self.lin(h, p["blocks_0/mixer/wk"][l]).view(B, S, K, hd)
            v = self.lin(h, p["blocks_0/mixer/wv"][l]).view(B, S, K, hd)
            if K != H:
                k = k.repeat_interleave(H // K, dim=2)
                v = v.repeat_interleave(H // K, dim=2)
            q, k = rope(q, c.rope_theta), rope(k, c.rope_theta)
            o = attend(q, k, v, 1.0 / math.sqrt(hd))
            return self.lin(o.reshape(B, S, H * hd), p["blocks_0/mixer/wo"][l])
        m = c.mla
        nope, rd, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        q = self.lin(h, p["blocks_0/mixer/wq"][l]).view(B, S, H, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], c.rope_theta)], -1)
        dkv = self.lin(h, p["blocks_0/mixer/w_dkv"][l])
        ckv = rms(dkv[..., :m.kv_lora_rank], p["blocks_0/mixer/kv_norm"][l],
                  c.rms_norm_eps)
        kpe = rope(dkv[..., None, m.kv_lora_rank:], c.rope_theta)
        kv = self.lin(ckv, p["blocks_0/mixer/w_ukv"][l]).view(B, S, H,
                                                             nope + dv)
        k = torch.cat([kv[..., :nope], kpe.expand(B, S, H, rd)], dim=-1)
        o = attend(q, k, kv[..., nope:],
                   1.0 / math.sqrt(nope + rd))
        return self.lin(o.reshape(B, S, H * dv), p["blocks_0/mixer/wo"][l])

    def moe(self, p: Params, l: int, h: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The MoE FFN of layer ``l`` and its load-balance loss."""
        mo = self.c.moe
        B, S, D = h.shape
        E, K = mo.n_routed_experts, mo.num_experts_per_tok
        probs = torch.softmax(h @ p["blocks_0/ffn/router"][l], dim=-1)
        idx = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[..., :K]          # (B, S, K)
        gates = torch.gather(probs, -1, idx)
        if mo.norm_topk_prob:
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = max(int(S * K / E * mo.capacity_factor), 1)
        onehot = F.one_hot(idx, E).to(torch.float32)            # (B,S,K,E)
        fill = torch.zeros(B, E, device=h.device)
        keep = torch.zeros(B, S, K, device=h.device)
        for r in range(K):
            mk = onehot[:, :, r]                                  # (B,S,E)
            pos = torch.cumsum(mk, dim=1) - mk + fill[:, None, :]
            keep[:, :, r] = ((pos < cap) * mk).sum(-1)
            fill = fill + mk.sum(1)
        w = gates * keep                                          # (B,S,K)
        xs = h.reshape(B * S, D)
        out = torch.zeros_like(xs)
        flat_idx, flat_w = idx.reshape(B * S, K), w.reshape(B * S, K)
        for e in range(E):
            tok, rank = torch.nonzero(flat_idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.swiglu(xs[tok], p["blocks_0/ffn/w_gate"][l, e],
                            p["blocks_0/ffn/w_up"][l, e],
                            p["blocks_0/ffn/w_down"][l, e])
            out = out.index_add(0, tok, y * flat_w[tok, rank][:, None])
        out = out.view(B, S, D)
        if mo.n_shared_experts:
            out = out + self.swiglu(h, p["blocks_0/ffn/shared/w_gate"][l],
                                    p["blocks_0/ffn/shared/w_up"][l],
                                    p["blocks_0/ffn/shared/w_down"][l])
        frac_tokens = onehot.sum(2).mean(dim=(0, 1))
        frac_probs = probs.mean(dim=(0, 1))
        aux = mo.aux_loss_coef * E * torch.sum(frac_tokens * frac_probs)
        return out, aux

    def logits(self, p: Params, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tokens (B, S)`` -> logits ``(B, S, V)`` over the real
        vocabulary, and the summed aux loss (0 without an MoE)."""
        c = self.c
        x = p["embed"][tokens] * c.scale_emb
        aux = torch.zeros((), device=x.device)
        for l in range(c.num_hidden_layers):
            h = rms(x, p["blocks_0/ln1"][l], c.rms_norm_eps)
            x = x + c.residual_scale * self.attention(p, l, h)
            h = rms(x, p["blocks_0/ln2"][l], c.rms_norm_eps)
            if c.moe is not None:
                f, a = self.moe(p, l, h)
                aux = aux + a
            else:
                f = self.swiglu(h, p["blocks_0/ffn/w_gate"][l],
                                p["blocks_0/ffn/w_up"][l],
                                p["blocks_0/ffn/w_down"][l])
            x = x + c.residual_scale * f
        x = rms(x, p["final_norm"], c.rms_norm_eps)
        V = c.vocab_size
        head = (p["embed"][:V].t() if c.tie_word_embeddings
                else p["lm_head"][:, :V])
        return self.lin(x, head), aux

    def loss(self, p: Params, tokens, labels) -> torch.Tensor:
        """Mean cross-entropy over the batch, plus the aux loss."""
        logits, aux = self.logits(p, tokens)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1))
        return ce + aux

    def sampled_loss(self, p: Params, tokens, gumbel) -> torch.Tensor:
        """The GNB's loss: cross-entropy against labels sampled from the
        model itself, ``argmax(logits + gumbel)`` (``gumbel (B, S, >=V)``,
        its first V columns read), plus the aux loss."""
        logits, aux = self.logits(p, tokens)
        V = logits.shape[-1]
        y = torch.argmax(logits.detach() + gumbel[..., :V], dim=-1)
        ce = F.cross_entropy(logits.reshape(-1, V), y.reshape(-1))
        return ce + aux
