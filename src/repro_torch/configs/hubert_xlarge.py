"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only (bidirectional); conv feature frontend stubbed —
input_specs provides frame embeddings. No decode shapes (DESIGN.md §5).
[arXiv:2106.07447]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, causal=False, ffn_kind="gelu",
    tie_embeddings=False, embedding_inputs=True, dtype="bfloat16",
)
FED = dict(strategy="parallel")
CITATION = "[arXiv:2106.07447]"
