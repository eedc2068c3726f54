"""The decoder's mapping onto the program: the port's arch config named
by the file's ``port`` key, with every size of the file."""
from __future__ import annotations

import dataclasses


def program_config(d: dict, conf):
    """The program's model config for configuration file ``d``, whose
    sizes the decoder's reference read as ``conf``."""
    from repro_torch import configs
    from repro_torch.configs.base import MLAConfig, MoEConfig
    ch = dict(num_layers=conf.num_hidden_layers, d_model=conf.hidden_size,
              num_heads=conf.num_attention_heads,
              num_kv_heads=conf.num_key_value_heads,
              vocab_size=conf.vocab_size,
              tie_embeddings=conf.tie_word_embeddings,
              rope_theta=conf.rope_theta, scale_emb=conf.scale_emb,
              residual_scale=conf.residual_scale,
              d_ff=conf.intermediate_size, dtype=conf.dtype)
    if conf.mla is not None:
        m = conf.mla
        ch["head_dim"] = conf.head_dim
        ch["mla"] = MLAConfig(kv_lora_rank=m.kv_lora_rank,
                              qk_nope_head_dim=m.qk_nope_head_dim,
                              qk_rope_head_dim=m.qk_rope_head_dim,
                              v_head_dim=m.v_head_dim)
    if conf.moe is not None:
        mo = conf.moe
        ch["moe"] = MoEConfig(num_experts=mo.n_routed_experts,
                              top_k=mo.num_experts_per_tok,
                              d_ff_expert=mo.moe_intermediate_size,
                              num_shared=mo.n_shared_experts,
                              d_ff_shared=mo.moe_intermediate_size,
                              capacity_factor=mo.capacity_factor,
                              aux_loss_coef=mo.aux_loss_coef)
    return dataclasses.replace(configs.get_model_config(d["port"]["arch"]),
                               **ch)
