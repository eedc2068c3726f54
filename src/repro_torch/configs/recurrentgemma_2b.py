"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680.
RG-LRU + local attention 2:1 (pattern rec,rec,local x8 + rec,rec).
[arXiv:2402.19427]"""
import math
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, block_pattern=("rec", "rec", "local"),
    window=2048, lru_width=2560, ffn_kind="geglu",
    scale_emb=math.sqrt(2560.0), tie_embeddings=True, dtype="bfloat16",
)
FED = dict(strategy="parallel")
CITATION = "[arXiv:2402.19427]"
