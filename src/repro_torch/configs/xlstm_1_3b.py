"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H, mLSTM:sLSTM 7:1.
mLSTM in chunkwise-parallel form; sLSTM sequential scan. [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    tie_embeddings=False, dtype="bfloat16",
)
FED = dict(strategy="parallel")
CITATION = "[arXiv:2405.04517]"
