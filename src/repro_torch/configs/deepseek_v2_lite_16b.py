"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=192,
    d_ff=0, vocab_size=102400, ffn_kind="swiglu",
    tie_embeddings=False, dtype="bfloat16",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=1408),
)
FED = dict(strategy="sequential")
CITATION = "[arXiv:2405.04434]"
