"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    ffn_kind="swiglu", tie_embeddings=False, dtype="bfloat16",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
)
FED = dict(strategy="sequential")
CITATION = "[hf:Qwen/Qwen3-30B-A3B]"
