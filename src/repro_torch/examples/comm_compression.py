"""Compressed federated communication: the paper's efficiency axis made
explicit, the twin of the JAX package's ``examples/comm_compression.py``.

Trains the same federated MLP under four regimes — lossless fp32
(identity), unbiased int8 stochastic quantization, top-k sparsification
with error feedback, and the fully bidirectional stack (int8 uplink +
int8 delta-coded broadcast + int4 Hessian-EMA stream) — and reports test
accuracy next to the exact cumulative bytes each regime put on the wire
(`repro_torch.comm.accounting.round_bytes`), all streams, both
directions.  Runs on the card; ``--device cpu`` runs on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.comm_compression \
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.comm.accounting import round_bytes
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as syn
from repro_torch.models.small import MLPTask

ROUNDS, CLIENTS, LOCAL_ITERS, IMAGES, HIDDEN = 12, 8, 10, 8192, 64

REGIMES = {
    "identity (fp32)": CommConfig(),
    "int8 stochastic": CommConfig(compressor="int8"),
    "top-k 5% + EF": CommConfig(compressor="topk", topk_ratio=0.05),
    "bidir int8/int8/int4": CommConfig(compressor="int8",
                                       downlink_compressor="int8",
                                       hessian_compressor="int4"),
}


def fed_config(comm: CommConfig) -> FedConfig:
    return FedConfig(num_clients=CLIENTS, local_iters=LOCAL_ITERS,
                     optimizer="fed_sophia", lr=0.02, tau=5,
                     total_rounds=ROUNDS, comm=comm)


def regime_bytes(n_params: int) -> Dict[str, Dict[str, int]]:
    """Each regime's wire bytes of one round (`round_bytes`)."""
    return {name: round_bytes(comm, n_params, CLIENTS)
            for name, comm in REGIMES.items()}


def _generator(device, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(salt)


def make_data(dev):
    """The images, labels and per-client train / test index split."""
    x, y = syn.make_image_data(_generator(dev, 0), IMAGES, "mnist",
                               noise=1.3)
    part = syn.dirichlet_partition(1, y, CLIENTS, alpha=0.5)
    train_idx, test_idx = syn.train_test_split(part)
    return x, y, train_idx, test_idx


def make_batches(dev, data, r: int):
    """Round ``r``'s client batches of `make_data`'s ``data``."""
    x, y, train_idx, _ = data
    return syn.client_batches(_generator(dev, 100 + r), x, y, train_idx, 64)


def main(argv=None) -> Dict[str, Any]:
    """Run the four regimes; returns each regime's per-round wire bytes,
    losses and test accuracies, and its engine."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.comm_compression")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = make_data(dev)
    x, y, _, test_idx = data
    task = MLPTask(hidden=HIDDEN)
    test_batches = syn.client_batches(_generator(dev, 2), x, y, test_idx,
                                      128)

    out: Dict[str, Any] = {}
    base_total = None
    for name, comm in REGIMES.items():
        engine = FedEngine(task, fed_config(comm), device=dev)
        state = engine.init(_generator(dev, 3))
        wire = round_bytes(comm, engine.num_params(state), CLIENTS)
        per_round = wire["total_bytes"]
        if base_total is None:
            base_total = per_round
        curv = wire["hessian_uplink_bytes"] + wire["hessian_downlink_bytes"]
        print(f"\n== {name}: {per_round / 2**20:.3f} MiB/round total "
              f"(up {wire['uplink_bytes'] / 2**20:.3f}"
              f" + down {wire['downlink_bytes'] / 2**20:.3f}"
              f" + curv {curv / 2**20:.3f};"
              f" {base_total / per_round:.1f}x reduction) ==")
        losses, accs = [], []
        for r in range(ROUNDS):
            state, metrics = engine.round(
                state, make_batches(dev, data, r),
                generator=_generator(dev, 1000 + r))
            losses.append(float(metrics["loss"]))
            if r % 4 == 0 or r == ROUNDS - 1:
                params = engine.unpack_params(state)
                acc = float(torch.mean(torch.stack([
                    task.accuracy(params, {k: v[c] for k, v in
                                           test_batches.items()})
                    for c in range(CLIENTS)])))
                accs.append(acc)
                print(f"round {r:3d}  loss={losses[-1]:.4f}"
                      f"  test-acc={acc:.3f}"
                      f"  cum-wire={(r + 1) * per_round / 2**20:.2f}MiB")
        out[name] = {"wire": wire, "losses": losses, "accuracy": accs,
                     "engine": engine}
    return out


if __name__ == "__main__":
    main()
