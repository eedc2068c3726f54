"""The weights of a cell, made from the seed on the device.

The layout is the program's input format: a flat dict keyed by
``/``-joined paths, every block's leaves stacked on a leading layer axis
under ``blocks_0/`` (``blocks_0/mixer/wq`` is ``(L, D, H*hd)``), the token
table ``embed`` of the padded vocabulary, ``lm_head`` when the head is
untied.  The reference reads the same dict by the same keys.

Values: every matrix N(0, 1/d_in), the token table N(0, (0.02 /
scale_emb)^2) (its scaled rows N(0, 0.02^2): a larger table makes a tied
head's logit of the input token dwarf the others, so the model starts
out certain of it and the GNB's sampled labels carry no gradient), every
norm weight 1; the MoE router in float32, everything else in the
configuration's ``torch_dtype`` (bfloat16), the dtype the model is
trained in.  All matrices of one dtype come from one ``torch.randn``
call, on the device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.conf import Conf

#: how a leaf is initialised
ONES, EMBED, DENSE = "ones", "embed", "dense"

Schema = Dict[str, Tuple[Tuple[int, ...], torch.dtype, str]]


def schema(conf: Conf) -> Schema:
    """key -> (shape, dtype, init) of every leaf."""
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


def count(conf: Conf) -> int:
    """Parameters of the model (the padded token rows included, as the
    program holds and trains them)."""
    return sum(math.prod(s) for s, _, _ in schema(conf).values())


def make(conf: Conf, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The weights, on the generator's device."""
    dev = generator.device
    sch = schema(conf)
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({dt for _, dt, _ in sch.values()}, key=str):
        keys = [k for k, (_, dt, init) in sch.items()
                if dt == dtype and init != ONES]
        n = sum(math.prod(sch[k][0]) for k in keys)
        if not n:
            continue
        draw = torch.randn(n, generator=generator, device=dev, dtype=dtype)
        off = 0
        for k in keys:
            shape, _, init = sch[k]
            size = math.prod(shape)
            scale = (0.02 / conf.scale_emb if init == EMBED
                     else 1.0 / math.sqrt(shape[-2]))
            out[k] = draw[off:off + size].view(shape) * scale
            off += size
        del draw
    for k, (shape, dt, init) in sch.items():
        if init == ONES:
            out[k] = torch.ones(shape, dtype=dt, device=dev)
    return {k: out[k] for k in sorted(out)}
