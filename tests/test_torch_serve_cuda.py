"""The port's serving path on the card: one decode-against-forward case a
cache kind, at a reduced size (``reduced(d_model=128)``, fp32 with tf32
off, a prompt of 20 tokens): the decode step's logits at position S,
from the prefill's cache of S tokens, equal the full forward's at
position S over S + 1, ``rtol=1e-3, atol=2e-3`` (the JAX package's own
invariant, tests/test_models.py); the cache stays on the card.

Every test needs an NVIDIA card, so each is marked ``cuda`` and skips
without one.  The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_serve_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as T

#: one arch a cache kind: GQA with qk-norm, rolling local beside global
#: (window 16, below the prompt), MLA with the MoE FFN, RG-LRU with its
#: conv, mLSTM and sLSTM, M-RoPE on embedding inputs
KINDS = {"gqa": ("qwen3-14b", {}),
         "local/global": ("gemma2-9b", {"window": 16}),
         "mla moe": ("deepseek-v2-lite-16b", {}),
         "rglru": ("recurrentgemma-2b", {"window": 16}),
         "mlstm slstm": ("xlstm-1.3b", {}),
         "mrope embeds": ("qwen2-vl-2b", {})}
S = 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: serving on the card")
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_equals_forward_on_the_card(card, kind):
    arch, fields = KINDS[kind]
    cfg = dataclasses.replace(
        configs.get_model_config(arch).reduced(d_model=128),
        dtype="float32", **fields)
    if cfg.moe is not None:      # no choice dropped at either length
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    g = torch.Generator(device=card).manual_seed(0)
    params = T.init_lm(g, cfg)
    if cfg.embedding_inputs:
        full = {"embeds": torch.randn(2, S + 1, cfg.d_model, device=card,
                                      generator=g)}
    else:
        full = {"tokens": torch.randint(0, cfg.vocab_size, (2, S + 1),
                                        device=card, generator=g)}
    with torch.no_grad():
        _, cache, _ = T.forward(params, cfg, {k: v[:, :S] for k, v in
                                              full.items()},
                                want_cache=True)
        cache = T.prefill_to_decode_cache(cfg, cache, S, S + 4)
        assert all(v.device.type == "cuda" for v in cache.values())
        dec, _ = T.decode_step(params, cfg, {k: v[:, S:] for k, v in
                                             full.items()}, cache, S)
        ref, _, _ = T.forward(params, cfg, full)
    torch.testing.assert_close(dec[:, 0], ref[:, S], rtol=1e-3, atol=2e-3)
