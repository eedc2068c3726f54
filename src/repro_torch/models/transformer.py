"""The decoder stack of the LM zoo: the port of the JAX package's
``models/transformer.py`` for every block kind of its configs but the
M-RoPE and embedding-input families: attention blocks (``attn``, or
gemma2's alternating ``local`` / ``global``) for minicpm-2b,
chatglm3-6b, gemma2-9b, qwen3-14b (dense), deepseek-v2-lite-16b (MLA
attention, MoE with shared experts) and qwen3-moe-235b-a22b (MoE), and
the recurrent mixers of `repro_torch.models.recurrent` (``rec``: RG-LRU,
``m``: mLSTM, ``s``: sLSTM) for recurrentgemma-2b and xlstm-1.3b.  The
features of those configs run as in JAX: a sliding window on ``local``
blocks (``long_mode_swa_only`` makes every ``global`` block ``local``),
the attention and final logit softcaps, post-norms (``post_ln1`` after
the mixer, ``post_ln2`` after the FFN, before each residual add),
qk-norm, GeGLU; with ``cfg.mla`` every attention block is an MLA block,
with ``cfg.moe`` every FFN a capacity-routed MoE whose Switch-style aux
loss, summed over the layers, is added to the loss.  A block has an FFN
(``ln2``, ``ffn/...``) only when ``d_ff > 0`` or ``cfg.moe`` is set
(xlstm-1.3b's blocks have none).

Parameters are the flat ``/``-keyed dict of `repro_torch.models.layers`:
``embed``, ``final_norm``, ``lm_head`` (untied configs), and the blocks
of block-pattern position ``pi`` stacked on a leading layer axis under
``blocks_{pi}/...`` (``blocks_0/mixer/wq`` is ``(L, D, H*hd)``, an
expert's ``blocks_0/ffn/w_gate`` ``(L, E, D, F)``), as the JAX package
stacks them for ``lax.scan``; the depth's remainder past the last whole
pattern as single blocks ``rem_{ri}/...``.  A depth below the pattern's
length leaves ``L = 0``: zero-length stacks, as JAX's ``vmap`` over no
keys builds them, which pack to nothing and train nothing.  `forward`
loops over that axis where JAX scans.  Every function also takes
parameters with a leading client axis ``(N, ...)`` (batch leaves ``(N,
B, S)``): the loss (and the aux loss) then comes back per client, shape
``(N,)``.

A Python float that scales activations (``scale_emb``,
``residual_scale``) is rounded to the activations' dtype first
(`layers.scalar`), as JAX rounds a weak-typed scalar: at bf16 the
products are JAX's bit for bit.

M-RoPE and embedding inputs raise `NotImplementedError` naming ROADMAP
queue 1 (g) 3.

GNB label sampling goes through the RNG seam: ``sampled_loss`` takes
gumbel noise of the logits' shape and samples ``argmax(logits +
gumbel)`` with the padded vocab masked, which is how
``jax.random.categorical`` samples, so the tests can inject the JAX
package's own draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the attention block kinds (full, sliding-window, and gemma2's global)
ATTN_KINDS = ("attn", "local", "global")
#: the recurrent mixers: (init, apply) of RG-LRU, mLSTM and sLSTM
RECURRENT = {"rec": (R.init_rglru, R.rglru_apply),
             "m": (R.init_mlstm, R.mlstm_apply),
             "s": (R.init_slstm, R.slstm_apply)}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP queue 1 (g) 3 "
        "(the port runs token-input decoders with RoPE: attention, MLA "
        "and recurrent mixers, dense, MoE or no FFN)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for M-RoPE and embedding inputs (the
    families this module does not run yet), `ValueError` for an unknown
    block kind."""
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS and kind not in RECURRENT:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    for field, what in (("mrope_sections", "M-RoPE"),
                        ("embedding_inputs", "embedding inputs")):
        if getattr(cfg, field):
            raise _not_ported(f"{cfg.name}: {what}")


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


def _mixer_kind(cfg: ModelConfig, kind: str) -> str:
    """Every attention kind is an MLA block when ``cfg.mla`` is set."""
    if kind in ATTN_KINDS and cfg.mla is not None:
        return "mla"
    return kind


def _effective_kind(cfg: ModelConfig, kind: str) -> str:
    """gemma2's long-context serving mode: global blocks fall back to
    the sliding window."""
    if kind == "global" and cfg.long_mode_swa_only:
        return "local"
    return kind


# --------------------------------------------------------------------------
# single block init / apply
# --------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype) -> Params:
    dev = generator.device

    def ones():
        return torch.ones(cfg.d_model, dtype=dtype, device=dev)
    p: Params = {"ln1": ones()}
    km = _mixer_kind(cfg, kind)
    init_mixer = (L.init_mla if km == "mla" else RECURRENT[km][0]
                  if km in RECURRENT else L.init_attention)
    p.update(L.prefixed("mixer", init_mixer(generator, cfg, dtype)))
    if cfg.post_norm:
        p["post_ln1"] = ones()
    if not _has_ffn(cfg):
        return p
    p["ln2"] = ones()
    ffn = (L.init_moe(generator, cfg, dtype) if cfg.moe is not None else
           L.init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                      dtype))
    p.update(L.prefixed("ffn", ffn))
    if cfg.post_norm:
        p["post_ln2"] = ones()
    return p


def apply_block(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(x, aux)``: ``aux`` the MoE's aux loss, None for a
    dense FFN or none."""
    kind = _effective_kind(cfg, kind)
    km = _mixer_kind(cfg, kind)
    h = L.rms_norm(x, p["ln1"])
    mixer = L.subtree(p, "mixer")
    if km == "mla":
        mix = L.mla_apply(mixer, cfg, h, positions)
    elif km in RECURRENT:
        mix = RECURRENT[km][1](mixer, cfg, h, positions)
    else:
        mix = L.attention_apply(mixer, cfg, h, positions, kind=kind)
    if cfg.post_norm:
        mix = L.rms_norm(mix, p["post_ln1"])
    x = x + L.scalar(cfg.residual_scale, mix) * mix
    if "ln2" not in p:
        return x, None
    h = L.rms_norm(x, p["ln2"])
    aux = None
    if cfg.moe is not None:
        f, aux = L.moe_apply(L.subtree(p, "ffn"), cfg, h)
    else:
        f = L.ffn_apply(L.subtree(p, "ffn"), cfg.ffn_kind, h)
    if cfg.post_norm:
        f = L.rms_norm(f, p["post_ln2"])
    return x + L.scalar(cfg.residual_scale, f) * f, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class _ShapeOnly(torch.Generator):
    """A generator whose draws land on the meta device: a block built
    from it has its leaves' shapes and dtypes and no storage."""
    device = torch.device("meta")


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights on the generator's device (the JAX package's
    layout and scales; the values are the generator's own)."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    dev = generator.device
    params: Params = {
        "embed": (torch.randn(cfg.vocab_padded, cfg.d_model,
                              generator=generator, device=dev)
                  * 0.02).to(dtype),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_padded, dtype)
    for pi, kind in enumerate(cfg.block_pattern):
        if cfg.pattern_reps:
            reps = [init_block(generator, cfg, kind, dtype)
                    for _ in range(cfg.pattern_reps)]
            stack = {k: torch.stack([r[k] for r in reps]) for k in reps[0]}
        else:
            # a depth below the pattern's length: zero-length stacks of
            # a block's leaves (their shapes drawn on the meta device)
            one = init_block(_ShapeOnly(), cfg, kind, dtype)
            stack = {k: torch.empty((0,) + v.shape, dtype=v.dtype,
                                    device=dev) for k, v in one.items()}
        params.update(L.prefixed(f"blocks_{pi}", stack))
    for ri, kind in enumerate(cfg.pattern_remainder):
        params.update(L.prefixed(f"rem_{ri}",
                                 init_block(generator, cfg, kind, dtype)))
    return params


def _n_lead(params: Params) -> int:
    return params["final_norm"].ndim - 1


def _embed_in(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    embed, tokens = params["embed"], batch["tokens"]
    n_lead = _n_lead(params)
    if n_lead == 0:
        x = embed[tokens]
    else:
        # each client reads its own table: (n, Vp, D)[client, token]
        lead = embed.shape[:n_lead]
        e = embed.reshape((-1,) + embed.shape[n_lead:])
        t = tokens.reshape((e.shape[0],) + tokens.shape[n_lead:])
        idx = torch.arange(e.shape[0], device=t.device).reshape(
            (-1,) + (1,) * (t.ndim - 1))
        x = e[idx, t].reshape(lead + tokens.shape[n_lead:] + e.shape[-1:])
    return x * L.scalar(cfg.scale_emb, x)


def _logits_out(params: Params, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    head = (params["lm_head"] if "lm_head" in params
            else params["embed"].transpose(-1, -2))
    logits = L.matmul(x, head)
    return L.softcap(logits.to(torch.float32), cfg.softcap_final)


def _default_positions(cfg: ModelConfig, B: int, S: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    pos = torch.arange(S, device=device) + offset
    return pos[None].expand(B, S)


def _blocks(params: Params, cfg: ModelConfig):
    """Each block's params and kind in the JAX package's order: every
    layer of pattern position 0 (its scan), then of position 1, ...,
    then the remainder blocks."""
    n_lead = _n_lead(params)
    for pi, kind in enumerate(cfg.block_pattern):
        stacked = L.subtree(params, f"blocks_{pi}")
        for layer in range(cfg.pattern_reps):
            yield {k: v.select(n_lead, layer)
                   for k, v in stacked.items()}, kind
    for ri, kind in enumerate(cfg.pattern_remainder):
        yield L.subtree(params, f"rem_{ri}"), kind


def forward(params: Params, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, None, Optional[torch.Tensor]]:
    """Full-sequence forward (train).  Returns ``(logits, None, aux)``:
    no cache (decode comes with the serving slice); ``aux`` the MoE's
    aux loss summed over the layers in order (``(*lead,)``), None for a
    dense FFN (where the JAX package returns 0)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    B, S = x.shape[-3], x.shape[-2]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, device=x.device)
    aux = None
    for bp, kind in _blocks(params, cfg):
        x, a = apply_block(bp, cfg, kind, x, positions)
        if a is not None:
            # the JAX scan's carry: 0 + a_0 + a_1 + ... (0 + a_0 is a_0)
            aux = a if aux is None else aux + a
    return _logits_out(params, cfg, x), None, aux


# --------------------------------------------------------------------------
# losses (CE over padded vocab) + Task abstraction
# --------------------------------------------------------------------------

def _mask_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    Vp = logits.shape[-1]
    if Vp <= vocab_size:
        return logits
    mask = torch.arange(Vp, device=logits.device) < vocab_size
    return torch.where(mask, logits,
                       torch.full((), L.MASK_VALUE, dtype=logits.dtype,
                                  device=logits.device))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """logits (..., B, S, Vp) fp32, labels (..., B, S).  Pad region
    masked out; the mean over (B, S), per leading index."""
    logits = _mask_pad(logits, vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - picked, dim=(-2, -1))


def sample_labels(logits: torch.Tensor, vocab_size: int,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` with its gumbel draw given:
    ``argmax(gumbel + logits)`` over the masked vocab."""
    return torch.argmax(gumbel + _mask_pad(logits, vocab_size), dim=-1)


def _plus(ce: torch.Tensor, aux: Optional[torch.Tensor]) -> torch.Tensor:
    return ce if aux is None else ce + aux


class LMTask:
    """Bundles init / loss / sampled loss of an LM for the federated
    engine.  Batches: ``tokens`` and ``labels`` ``(*lead, B, S)``."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator, device=None) -> Params:
        params = init_lm(generator, self.cfg)
        return {k: v.to(device or generator.device)
                for k, v in params.items()}

    def logits(self, params: Params, batch):
        logits, _, aux = forward(params, self.cfg, batch)
        return logits, aux

    def loss(self, params: Params, batch, rng=None):
        """CE plus the MoE's aux loss (a dense decoder has none)."""
        logits, aux = self.logits(params, batch)
        return _plus(cross_entropy(logits, batch["labels"],
                                   self.cfg.vocab_size), aux)

    def sampled_loss(self, params: Params, batch, gumbel: torch.Tensor):
        """GNB inner loss: CE against labels sampled from the model
        itself (``gumbel``: the noise of the logits' shape), plus the
        aux loss, as in JAX."""
        logits, aux = self.logits(params, batch)
        y = sample_labels(logits.detach(), self.cfg.vocab_size, gumbel)
        return _plus(cross_entropy(logits, y, self.cfg.vocab_size), aux)

    def gnb_batch_size(self, batch) -> int:
        lab = batch["labels"]
        return int(lab.shape[-2] * lab.shape[-1])

    def gumbel_shape(self, batch) -> Tuple[int, ...]:
        """One client's GNB noise shape: its logits', ``(B, S, Vp)``."""
        return tuple(batch["labels"].shape[-2:]) + (self.cfg.vocab_padded,)
