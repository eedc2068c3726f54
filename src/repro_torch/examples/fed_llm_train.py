"""End-to-end driver: federated Fed-Sophia pre-training of a ~100M-param
decoder LM (minicpm-family reduced) on a synthetic token stream, the twin
of the JAX package's ``examples/fed_llm_train.py`` with its defaults.

The default runs a ~100M model for 100 rounds x 3 local iterations = 300
local steps; ``--small`` is a quick functional check.  Runs on the card;
``--device cpu`` runs on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.fed_llm_train --small \
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.fed_llm_train

The checkpoint goes to ``build/fed_llm_ckpt`` (``--ckpt ''``: none).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as syn
from repro_torch.models import transformer as T

#: generator salts: the weights, round r's batches, round r's GNB noise
_INIT_SALT, _BATCH_SALT, _ROUND_SALT = 0, 100, 1000


def build_cfg(small: bool):
    base = configs.get_model_config("minicpm-2b")
    if small:
        return base.reduced(d_model=128)
    # ~100M-param member of the same family (depth-scaled residuals, WSD)
    return dataclasses.replace(
        base.reduced(num_layers=8, d_model=512),
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=1536, vocab_size=32768, dtype="float32",
        residual_scale=1.4 / (8 ** 0.5))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.fed_llm_train")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="build/fed_llm_ckpt")
    return ap


def parse(argv=None):
    """The parsed ``argv``: ``--small`` runs 5 rounds of batch 2 at seq
    64, as in the JAX example."""
    args = build_parser().parse_args(argv)
    if args.small:
        args.rounds, args.seq, args.batch = 5, 64, 2
    return args


def build_engine(args, device) -> FedEngine:
    """The example's engine: Fed-Sophia with a WSD schedule over
    ``args.rounds``, tau 5."""
    fed = FedConfig(num_clients=args.clients, local_iters=args.local_iters,
                    optimizer="fed_sophia", lr=args.lr, tau=5,
                    schedule="wsd", total_rounds=args.rounds,
                    warmup_rounds=max(args.rounds // 20, 1))
    return FedEngine(T.LMTask(build_cfg(args.small)), fed, device=device)


def _generator(device, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(salt)


def main(argv=None) -> Dict[str, Any]:
    """Run the example; returns the engine, the final state and the
    per-round losses."""
    args = parse(argv)
    dev = resolve_device(args.device)
    engine = build_engine(args, dev)
    cfg, fed = engine.task.cfg, engine.fed
    state = engine.init(_generator(dev, _INIT_SALT))
    n_params = engine.num_params(state)
    print(f"model={cfg.name}-reduced  params={n_params / 1e6:.1f}M  "
          f"clients={fed.num_clients} J={fed.local_iters} "
          f"rounds={args.rounds} (WSD schedule) device={dev}")
    losses = []
    t_start = time.time()
    for r in range(args.rounds):
        batches = syn.make_token_batch(
            _generator(dev, _BATCH_SALT + r), fed.num_clients, args.batch,
            args.seq, cfg.vocab_size, device=dev)
        state, metrics = engine.round(
            state, batches, generator=_generator(dev, _ROUND_SALT + r))
        losses.append(float(metrics["loss"]))
        if r % max(args.rounds // 20, 1) == 0 or r == args.rounds - 1:
            print(f"round {r:4d}  loss={losses[-1]:.4f}  "
                  f"lr={float(metrics['lr']):.2e}  "
                  f"({time.time() - t_start:.0f}s)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt, state["params"], step=args.rounds,
                  extra={"cfg": cfg.name, "params_m": n_params / 1e6})
        print(f"checkpoint -> {args.ckpt}")
    return {"engine": engine, "state": state, "losses": losses}


if __name__ == "__main__":
    main()
