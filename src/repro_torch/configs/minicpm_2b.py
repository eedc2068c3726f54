"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA) d_ff=5760 vocab=122753.
WSD schedule, depth-scaled residuals (1.4/sqrt(L)), scale_emb=12.
[arXiv:2404.06395]"""
import math
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, ffn_kind="swiglu",
    residual_scale=1.4 / math.sqrt(40), scale_emb=12.0,
    tie_embeddings=True, dtype="bfloat16",
)
FED = dict(strategy="parallel", schedule="wsd")
CITATION = "[arXiv:2404.06395]"
