"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000. Alternating local(4096)/global attention, logit softcaps,
GeGLU, post-norms. [arXiv:2408.00118]"""
import math
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, block_pattern=("local", "global"),
    window=4096, softcap_attn=50.0, softcap_final=30.0, post_norm=True,
    ffn_kind="geglu", scale_emb=math.sqrt(3584.0),
    tie_embeddings=True, dtype="bfloat16",
)
FED = dict(strategy="sequential")
CITATION = "[arXiv:2408.00118]"
