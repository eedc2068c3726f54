"""The plain reference of the benchmark's two language models: the
decoder's forward pass, loss and GNB label sampling in float32, written
from the published descriptions (MiniCPM, arXiv:2404.06395; DeepSeek-V2,
arXiv:2405.04434) and the configuration file's sizes.  It imports
nothing of the program; it reads the weights dict the benchmark made
(`portbench.weights` names its keys).

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
``torch.backends.cuda.matmul.allow_tf32`` (`no_tf32`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.conf import Conf

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over the last axis of ``x (B, S, H, r)`` at positions 0..S-1:
    frequencies ``theta^(-i / (r/2))``, the first half rotated against
    the second."""
    S, r = x.shape[1], x.shape[-1]
    half = r // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention: ``q, k (B, S, H, dk)``, ``v (B, S, H, dv)``."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class Model:
    """The reference LM of one configuration over one client's weights
    (float32 leaves keyed as `portbench.weights.schema` names them)."""

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
