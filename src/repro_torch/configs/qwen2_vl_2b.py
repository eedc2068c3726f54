"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE (t/h/w sections 16/24/24 of the 64 rotary slots).
ViT frontend stubbed — input_specs provides patch embeddings.
[arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, mrope_sections=(16, 24, 24),
    rope_theta=1e6, ffn_kind="swiglu", tie_embeddings=True,
    embedding_inputs=True, dtype="bfloat16",
)
FED = dict(strategy="parallel")
CITATION = "[arXiv:2409.12191]"
