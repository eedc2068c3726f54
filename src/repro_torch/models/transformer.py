"""The decoder stack of the LM zoo: the port of the JAX package's
``models/transformer.py`` for every arch of its configs: attention
blocks (``attn``, or gemma2's alternating ``local`` / ``global``) for
minicpm-2b, chatglm3-6b, gemma2-9b, qwen3-14b (dense), deepseek-v2-lite-16b
(MLA attention, MoE with shared experts), qwen3-moe-235b-a22b (MoE),
qwen2-vl-2b (M-RoPE over ``(3, B, S)`` positions, embedding inputs) and
hubert-xlarge (a bidirectional encoder, ``causal=False``, on embedding
inputs), and the recurrent mixers of `repro_torch.models.recurrent`
(``rec``: RG-LRU, ``m``: mLSTM, ``s``: sLSTM) for recurrentgemma-2b and
xlstm-1.3b.  The features of those configs run as in JAX: a sliding
window on ``local`` blocks (``long_mode_swa_only`` makes every
``global`` block ``local``), the attention and final logit softcaps,
post-norms (``post_ln1`` after the mixer, ``post_ln2`` after the FFN,
before each residual add), qk-norm, GeGLU; with ``cfg.mla`` every
attention block is an MLA block, with ``cfg.moe`` every FFN a
capacity-routed MoE whose Switch-style aux loss, summed over the
layers, is added to the loss.  A block has an FFN (``ln2``,
``ffn/...``) only when ``d_ff > 0`` or ``cfg.moe`` is set (xlstm-1.3b's
blocks have none).  An embedding-input config reads ``batch["embeds"]``
(a frontend's output, cast to the parameters' dtype) where the others
read ``tokens``; its ``embed`` table then serves decode's next input
and, tied, the head.

Parameters are the flat ``/``-keyed dict of `repro_torch.models.layers`:
``embed``, ``final_norm``, ``lm_head`` (untied configs), and the blocks
of block-pattern position ``pi`` stacked on a leading layer axis under
``blocks_{pi}/...`` (``blocks_0/mixer/wq`` is ``(L, D, H*hd)``, an
expert's ``blocks_0/ffn/w_gate`` ``(L, E, D, F)``), as the JAX package
stacks them for ``lax.scan``; the depth's remainder past the last whole
pattern as single blocks ``rem_{ri}/...``.  A depth below the pattern's
length leaves ``L = 0``: zero-length stacks, as JAX's ``vmap`` over no
keys builds them, which pack to nothing and train nothing.  `forward`
loops over that axis where JAX scans.  Every training function also
takes parameters with a leading client axis ``(N, ...)`` (batch leaves
``(N, B, S)``): the loss (and the aux loss) then comes back per client,
shape ``(N,)``.

Serving (the JAX package's, function for function): ``forward(...,
want_cache=True)`` returns each layer's cache, `prefill_to_decode_cache`
turns it into the decode layout, `init_cache` builds an empty one and
`decode_step` runs one token through every layer at a position the
host gives, writing the cache in place.  A cache is a flat ``/``-keyed
dict with the JAX tree's paths (``g0/k`` stacked over pattern position
0's layers, ``r1/state`` a remainder block's), so caches compare leaf
by leaf; serving takes parameters without a client axis.

A Python float that scales activations (``scale_emb``,
``residual_scale``) is rounded to the activations' dtype first
(`layers.scalar`), as JAX rounds a weak-typed scalar: at bf16 the
products are JAX's bit for bit.

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
#: their empty decode caches
RECURRENT_CACHE = {"rec": R.init_rglru_cache, "m": R.init_mlstm_cache,
                   "s": R.init_slstm_cache}


def check_supported(cfg: ModelConfig) -> None:
    """Raise `ValueError` for an unknown block kind (every block kind,
    family and input feature of the zoo runs)."""
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS and kind not in RECURRENT:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")


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
                positions: torch.Tensor, *, cache=None,
                pos: Optional[int] = None, want_cache: bool = False):
    """Returns ``(x, aux)``: ``aux`` the MoE's aux loss, None for a
    dense FFN or none; with ``want_cache`` or a ``cache`` (decode at
    ``pos``, written in place) ``(x, aux, cache)``, the mixer's cache."""
    kind = _effective_kind(cfg, kind)
    km = _mixer_kind(cfg, kind)
    h = L.rms_norm(x, p["ln1"])
    mixer = L.subtree(p, "mixer")
    cached = want_cache or cache is not None
    kw = dict(cache=cache, pos=pos, want_cache=True) if cached else {}
    if km == "mla":
        mix = L.mla_apply(mixer, cfg, h, positions, **kw)
    elif km in RECURRENT:
        mix = RECURRENT[km][1](mixer, cfg, h, positions, **kw)
    else:
        mix = L.attention_apply(mixer, cfg, h, positions, kind=kind, **kw)
    new_cache = None
    if cached:
        mix, new_cache = mix
    if cfg.post_norm:
        mix = L.rms_norm(mix, p["post_ln1"])
    x = x + L.scalar(cfg.residual_scale, mix) * mix
    aux = None
    if "ln2" in p:
        h = L.rms_norm(x, p["ln2"])
        if cfg.moe is not None:
            f, aux = L.moe_apply(L.subtree(p, "ffn"), cfg, h)
        else:
            f = L.ffn_apply(L.subtree(p, "ffn"), cfg.ffn_kind, h)
        if cfg.post_norm:
            f = L.rms_norm(f, p["post_ln2"])
        x = x + L.scalar(cfg.residual_scale, f) * f
    return (x, aux, new_cache) if cached else (x, aux)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device=None) -> Params:
    """A block's empty decode cache (``long_mode_swa_only`` makes a
    ``global`` block's a ``local`` one's)."""
    kind = _effective_kind(cfg, kind)
    km = _mixer_kind(cfg, kind)
    if km == "mla":
        return L.init_mla_cache(cfg, batch, max_len, dtype, device)
    if km in ATTN_KINDS:
        return L.init_attention_cache(cfg, kind, batch, max_len, dtype,
                                      device)
    return RECURRENT_CACHE[km](cfg, batch, dtype, device)


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
    """The input embeddings: ``batch["embeds"]`` cast to the parameters'
    dtype for an embedding-input config (a frontend's output), else each
    token's row of ``embed`` (each client's own table under a client
    axis); times ``scale_emb``."""
    if cfg.embedding_inputs:
        x = batch["embeds"].to(param_dtype(cfg))
        return x * L.scalar(cfg.scale_emb, x)
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
    # widened at once: the narrow logits are not kept beside the softcap's
    logits = L.matmul(x, head).to(torch.float32)
    return L.softcap(logits, cfg.softcap_final)


def _default_positions(cfg: ModelConfig, B: int, S: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """Positions ``offset ... offset + S - 1`` as ``(B, S)``, or ``(3,
    B, S)`` (every M-RoPE channel the same: a text-only input) for an
    M-RoPE config."""
    pos = (torch.arange(S, device=device) + offset)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, S)
    return pos


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


def _groups(cfg: ModelConfig):
    """The cache groups in the JAX package's order: ``(name, kind,
    layers)``, ``g{pi}`` a block-pattern position's stacked layers,
    ``r{ri}`` a remainder block (``layers`` None)."""
    for pi, kind in enumerate(cfg.block_pattern):
        yield f"g{pi}", kind, cfg.pattern_reps
    for ri, kind in enumerate(cfg.pattern_remainder):
        yield f"r{ri}", kind, None


def forward(params: Params, cfg: ModelConfig, batch, *,
            want_cache: bool = False):
    """Full-sequence forward (train / prefill).  Returns ``(logits,
    cache, aux)``: ``cache`` None unless ``want_cache``; ``aux`` the
    MoE's aux loss summed over the layers in order (``(*lead,)``), None
    for a dense FFN (where the JAX package returns 0).

    The cache is the flat ``/``-keyed dict of the JAX package's tree:
    ``g{pi}/<leaf>`` a block-pattern position's caches stacked on a
    leading layer axis (attention ``k`` and ``v`` ``(L, B, S, K, hd)``,
    MLA ``ckv`` and ``kpe``, the recurrent states), ``r{ri}/<leaf>`` a
    remainder block's; serving takes parameters without a client
    axis."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    B, S = x.shape[-3], x.shape[-2]
    if want_cache and _n_lead(params):
        raise ValueError("a cache is built for parameters without a "
                         "client axis")
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, device=x.device)
    aux = None
    layer_caches, c = [], []
    for bp, kind in _blocks(params, cfg):
        x, a, *c = apply_block(bp, cfg, kind, x, positions,
                               want_cache=want_cache)
        layer_caches += c
        if a is not None:
            # the JAX scan's carry: 0 + a_0 + a_1 + ... (0 + a_0 is a_0)
            aux = a if aux is None else aux + a
    cache = (_stack_caches(cfg, layer_caches, B, S, x) if want_cache
             else None)
    del layer_caches, c     # the stacks hold the caches now
    return _logits_out(params, cfg, x), cache, aux


def _stack_caches(cfg: ModelConfig, layer_caches, B: int, S: int,
                  x: torch.Tensor) -> Params:
    """The per-layer caches (in `_blocks`' order) as the flat cache of
    `forward`: each pattern position's stacked on a leading layer axis
    (a depth below the pattern: zero-length stacks of a prefill cache's
    shapes, as JAX's scan over no layers gives)."""
    cache: Params = {}
    it = iter(layer_caches)
    for name, kind, layers in _groups(cfg):
        if layers is None:
            cache.update(L.prefixed(name, next(it)))
        elif layers:
            group = [next(it) for _ in range(layers)]
            cache.update(L.prefixed(name, {
                k: torch.stack([c[k] for c in group]) for k in group[0]}))
        else:
            # full-length attention caches: a prefill holds every position
            shape_kind = "attn" if kind in ATTN_KINDS else kind
            one = init_block_cache(cfg, shape_kind, B, S, x.dtype, "meta")
            cache.update(L.prefixed(name, {
                k: torch.empty((0,) + v.shape, dtype=v.dtype,
                               device=x.device) for k, v in one.items()}))
    return cache


def _subtrees(cache: Params) -> Dict[str, Params]:
    """The flat cache as ``{group: {leaf: tensor}}``."""
    out: Dict[str, Params] = {}
    for key, v in cache.items():
        group, leaf = key.split("/", 1)
        out.setdefault(group, {})[leaf] = v
    return out


def prefill_to_decode_cache(cfg: ModelConfig, cache: Params,
                            prefill_len: int, max_len: int) -> Params:
    """`forward`'s cache in `decode_step`'s layout (the JAX package's
    ``prefill_to_decode_cache``).  Full attention and MLA: the sequence
    axis zero-padded to ``max_len``.  ``local`` attention: the last W =
    ``min(window, max_len)`` positions regrouped into the rolling
    buffer, slot ``j`` holding the latest position ``== j (mod W)``
    (``src = j + ((P - 1 - j) // W) W`` clipped into ``[0, P - 1]``;
    slots past a short prompt are masked at decode by ``k_valid``).
    Recurrent states pass through (the same tensors)."""
    kinds = {name: kind for name, kind, _ in _groups(cfg)}
    new: Params = {}
    for group, c in _subtrees(cache).items():
        kind = _effective_kind(cfg, kinds[group])
        seq_axis = 2 if group.startswith("g") else 1   # the layer axis
        if "k" in c and kind == "local" and cfg.window and prefill_len > 0:
            W = min(cfg.window, max_len)
            idx = torch.arange(W)
            src = idx + torch.div(prefill_len - 1 - idx, W,
                                  rounding_mode="floor") * W
            src = torch.clamp(src, 0, prefill_len - 1)
            out = {k: torch.index_select(a, seq_axis, src.to(a.device))
                   for k, a in c.items()}
        elif "k" in c or "ckv" in c:
            out = {k: _grow(a, seq_axis, max_len) for k, a in c.items()}
        else:
            out = c
        new.update(L.prefixed(group, out))
    return new


def _grow(a: torch.Tensor, axis: int, length: int) -> torch.Tensor:
    """``a`` zero-padded at the end of ``axis`` to ``length`` (as it is
    when not shorter)."""
    if a.shape[axis] >= length:
        return a
    pad = list(a.shape)
    pad[axis] = length - a.shape[axis]
    return torch.cat([a, a.new_zeros(pad)], dim=axis)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> Params:
    """The empty decode cache of the whole model (each pattern position's
    block caches stacked over its layers)."""
    dtype = param_dtype(cfg)
    cache: Params = {}
    for name, kind, layers in _groups(cfg):
        one = init_block_cache(cfg, kind, batch_size, max_len, dtype,
                               device)
        if layers is not None:
            one = {k: v[None].repeat((layers,) + (1,) * v.ndim)
                   for k, v in one.items()}
        cache.update(L.prefixed(name, one))
    return cache


def decode_step(params: Params, cfg: ModelConfig, batch, cache: Params,
                pos: int):
    """One-token decode.  ``batch``: ``tokens (B, 1)`` or ``embeds (B,
    1, D)`` (and optionally ``positions``; by default ``pos``, as ``(3,
    B, 1)`` for M-RoPE); ``pos`` the token's absolute position (a Python
    int: the host knows it).  Returns ``(logits (B, 1, Vp), cache)``:
    the cache is written in place (each layer's slice of its stack) and
    returned."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, x.shape[-3], 1, offset=pos,
                                       device=x.device)
    groups = _subtrees(cache)
    for name, kind, layers in _groups(cfg):
        if layers is None:
            x, _, _ = apply_block(L.subtree(params, f"rem_{name[1:]}"), cfg,
                                  kind, x, positions, cache=groups[name],
                                  pos=pos)
            continue
        stacked = L.subtree(params, f"blocks_{name[1:]}")
        for layer in range(layers):
            x, _, _ = apply_block(
                {k: v[layer] for k, v in stacked.items()}, cfg, kind, x,
                positions, cache={k: v[layer] for k, v in
                                  groups[name].items()}, pos=pos)
    return _logits_out(params, cfg, x), cache


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
    engine.  Batches: ``tokens`` (or an embedding-input config's
    ``embeds (*lead, B, S, D)``) and ``labels`` ``(*lead, B, S)``."""

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
