"""Serving launcher of the port: batched prefill and a decode loop for any
decoder arch of the zoo, the twin of the JAX package's
``repro/launch/serve.py`` with its arguments plus ``--device`` and
``--layers`` (cut the depth, keep the published widths).  Runs on the
card; ``--device cpu`` runs on the CPU (the tests' route).  Without a
card and without that flag it raises:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --reduced --prompt-len 16 --gen 8 --batch 2 --device cpu

Flow, as in the JAX CLI: the prompt's forward with its caches
(``forward(want_cache=True)``) and `prefill_to_decode_cache` to ``prompt
+ gen`` positions (the prefill, timed), a token sampled from the last
position's logits, then ``gen - 1`` decode steps, each feeding the last
sampled token (an embedding-input arch: its row of ``embed``) at the
next position and sampling the next.  The host clock is read after a
synchronise, around the prefill and each decode step; ``--obs-log``
writes the run's ``serve`` record (tokens/s, prefill seconds, the
decode steps' p50 / p95 / p99 ms) through `obs.RunRecorder`.  An
encoder-only arch (hubert-xlarge) has no decode and is refused.

Randomness: the weights (the training CLI's for the same ``--seed``),
the prompt and each sampling step's gumbel noise come from
`torch.Generator`s seeded from ``--seed``.  `main` also takes ``hooks``
(the RNG seam of the tests): ``params`` (numpy arrays, flat or nested),
``prompt`` (the ``tokens`` or ``embeds`` batch, numpy) and ``gumbel``
(step -> the ``(B, Vp)`` noise of sampling step ``i``; step 0 samples
from the prefill's logits).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs, convert, obs, resolve_device
from repro_torch.launch.train import _generator, model_config
from repro_torch.models import transformer as T
from repro_torch.models.small import gumbel_noise

#: generator salts: weights (the training CLI's), the prompt, sampling
#: step i's gumbel noise
_INIT_SALT, _PROMPT_SALT, _SAMPLE_SALT = 0, 1, 100


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batched prefill + decode loop for a decoder arch of "
                    "the zoo, on the card (or --device cpu).")
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, keeping the "
                         "published widths (0 = the config's depth)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace (annotated "
                         "prefill / decode_step ranges) into this "
                         "directory")
    ap.add_argument("--obs-log", default="",
                    help="write the structured `serve` record (tokens/s, "
                         "prefill / decode latency percentiles) to this "
                         "JSONL")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _percentile(q, p: float) -> float:
    """The JAX CLI's nearest-rank percentile of the sorted ``q``."""
    return q[min(len(q) - 1, int(round(p * (len(q) - 1))))]


def main(argv=None, *, hooks: Optional[Dict[str, Any]] = None
         ) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None).  Returns the
    sampled ``tokens (B, gen)``, the ``logits`` each was sampled from
    (``(B, Vp)`` fp32, before the temperature: the prefill's last
    position, then each decode step's), the ``params`` and ``prompt``
    served, ``prefill_s``, the decode steps' ``step_ms``,
    ``tokens_per_s`` and the records written (with ``--obs-log``)."""
    args = build_parser().parse_args(argv)
    hooks = hooks or {}
    dev = resolve_device(args.device)
    cfg = model_config(args)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode")
    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G
    if "params" in hooks:
        params = convert.params_from_numpy(hooks["params"], dev)
    else:
        params = T.init_lm(_generator(dev, args.seed, _INIT_SALT), cfg)
    if "prompt" in hooks:
        prompt = {k: torch.as_tensor(v, device=dev)
                  for k, v in hooks["prompt"].items()}
    elif cfg.embedding_inputs:
        prompt = {"embeds": torch.randn(
            (B, P, cfg.d_model), device=dev,
            generator=_generator(dev, args.seed, _PROMPT_SALT)).to(
                T.param_dtype(cfg))}
    else:
        prompt = {"tokens": torch.randint(
            0, cfg.vocab_size, (B, P), device=dev,
            generator=_generator(dev, args.seed, _PROMPT_SALT))}

    def sample(logits, step):
        if "gumbel" in hooks:
            noise = torch.as_tensor(hooks["gumbel"](step), device=dev)
        else:
            noise = gumbel_noise(
                _generator(dev, args.seed, _SAMPLE_SALT + step),
                logits.shape)
        return T.sample_labels(logits / args.temperature, cfg.vocab_size,
                               noise)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    recorder = None
    if args.obs_log:
        recorder = obs.RunRecorder(
            args.obs_log,
            meta={"arch": cfg.name, "batch": B, "prompt_len": P, "gen": G,
                  "mode": "serve", "device": str(dev)})

    with torch.no_grad(), obs.profile_trace(args.profile_dir):
        sync()
        t0 = time.perf_counter()
        with obs.annotate("prefill"):
            logits, cache, _ = T.forward(params, cfg, prompt,
                                         want_cache=True)
            cache = T.prefill_to_decode_cache(cfg, cache, P, max_len)
            # a copy: a view would hold the whole (B, P, Vp) tensor
            step_logits = [logits[:, -1].clone()]
            del logits
        sync()
        prefill_s = time.perf_counter() - t0
        print(f"prefill ({B}x{P}): {prefill_s:.2f}s")
        tok = sample(step_logits[0], 0)
        out_tokens = [tok]
        step_ms = []
        sync()
        t0 = time.perf_counter()
        for i in range(G - 1):
            ts = time.perf_counter()
            if cfg.embedding_inputs:
                step_in = {"embeds": params["embed"][tok][:, None, :]}
            else:
                step_in = {"tokens": tok[:, None]}
            with obs.annotate("decode_step"):
                lg, cache = T.decode_step(params, cfg, step_in, cache, P + i)
            step_logits.append(lg[:, -1])
            tok = sample(lg[:, -1], i + 1)
            out_tokens.append(tok)
            sync()
            step_ms.append((time.perf_counter() - ts) * 1e3)
        dt = time.perf_counter() - t0
    del cache
    toks = torch.stack(out_tokens, dim=1)
    tok_s = G * B / max(dt, 1e-9)
    print(f"decoded {G} tokens x {B} seqs in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print("sampled token ids:", toks.tolist())
    records = None
    if recorder is not None:
        rec = {"record": "serve", "tokens_per_s": tok_s,
               "prefill_s": prefill_s, "decode_steps": G, "batch": B}
        if step_ms:
            q = sorted(step_ms)
            rec.update(decode_p50_ms=_percentile(q, 0.50),
                       decode_p95_ms=_percentile(q, 0.95),
                       decode_p99_ms=_percentile(q, 0.99))
        recorder.emit(rec)
        recorder.close()
        records = recorder.ring.records()
        print(f"wrote {recorder.counts} obs records to {args.obs_log}")
    return {"tokens": toks, "logits": step_logits, "params": params,
            "prompt": prompt, "prefill_s": prefill_s, "step_ms": step_ms,
            "tokens_per_s": tok_s, "records": records}


if __name__ == "__main__":
    main()
