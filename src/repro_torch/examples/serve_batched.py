"""Batched serving example: prefill a batch of prompts, then greedy
decode with a KV cache (`models.transformer.decode_step`) — the step the
``decode_32k`` / ``long_500k`` dry-run shapes trace, here at the reduced
size (d_model 128); the twin of the JAX package's
``examples/serve_batched.py``.  Runs on the card; ``--device cpu`` runs
on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch chatglm3-6b [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch xlstm-1.3b [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs, convert, resolve_device
from repro_torch.models import transformer as T


def main(argv=None, *, hooks: Optional[Dict[str, Any]] = None
         ) -> Dict[str, Any]:
    """Run the example.  ``hooks`` (the tests' seam): ``cfg`` (the
    `ModelConfig` to serve in place of the arch's reduced one),
    ``params`` (numpy arrays, flat or nested) and ``prompt`` (the
    ``tokens`` or ``embeds`` batch, numpy).  Returns the greedy ``tokens (B, gen)`` and the
    ``logits`` each was taken from (``(B, Vp)`` fp32: the prefill's last
    position, then each decode step's)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_batched")
    ap.add_argument("--arch", default="chatglm3-6b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    hooks = hooks or {}
    dev = resolve_device(args.device)

    cfg = hooks.get("cfg") or configs.get_model_config(args.arch).reduced(
        d_model=128)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "params" in hooks:
        params = convert.params_from_numpy(hooks["params"], dev)
    else:
        params = T.init_lm(gen, cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    if "prompt" in hooks:
        prompt = {k: torch.as_tensor(v, device=dev)
                  for k, v in hooks["prompt"].items()}
    elif cfg.embedding_inputs:
        prompt = {"embeds": torch.randn((B, P, cfg.d_model), generator=gen,
                                        device=dev).to(T.param_dtype(cfg))}
    else:
        prompt = {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                          generator=gen, device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        t0 = time.time()
        logits, cache, _ = T.forward(params, cfg, prompt, want_cache=True,
                                     remat=False)
        cache = T.prefill_to_decode_cache(cfg, cache, P, P + G)
        step_logits = [logits[:, -1].float()]
        del logits
        sync()
        print(f"prefill {B}x{P}: {time.time() - t0:.2f}s")

        tok = torch.argmax(step_logits[0][:, :cfg.vocab_size], -1)
        generated = [tok]
        t0 = time.time()
        for i in range(G - 1):
            if cfg.embedding_inputs:
                nxt = {"embeds": params["embed"][tok][:, None].to(
                    T.param_dtype(cfg))}
            else:
                nxt = {"tokens": tok[:, None]}
            lg, cache = T.decode_step(params, cfg, nxt, cache, P + i)
            step_logits.append(lg[:, -1].float())
            tok = torch.argmax(step_logits[-1][:, :cfg.vocab_size], -1)
            generated.append(tok)
        sync()
        dt = time.time() - t0
    print(f"greedy-decoded {G} x {B} tokens in {dt:.2f}s "
          f"({B * G / max(dt, 1e-9):.1f} tok/s)")
    print("token ids[0]:", [int(t[0]) for t in generated])
    return {"tokens": torch.stack(generated, dim=1), "logits": step_logits}


if __name__ == "__main__":
    main()
