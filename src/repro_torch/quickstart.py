"""Quickstart: the paper's core experiment on the port.

Federated training of an MLP on synthetic non-IID MNIST with Fed-Sophia
vs FedAvg — the Fig. 2 behaviour: Fed-Sophia reaches the target
accuracy in fewer communication rounds.  The twin of the JAX package's
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart                # card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu   # plain versions
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as syn
from repro_torch.models.small import MLPTask

ROUNDS, CLIENTS = 25, 8


def main(device=None, rounds: int = ROUNDS) -> None:
    dev = resolve_device(device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    x, y = syn.make_image_data(gen(0), 8192, "mnist", noise=1.3)
    part = syn.dirichlet_partition(1, y, CLIENTS, alpha=0.5)
    train_idx, test_idx = syn.train_test_split(part)
    task = MLPTask(hidden=64)
    test = syn.client_batches(gen(2), x, y, test_idx, 128)
    test = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in test.items()}

    for optimizer, lr in (("fed_sophia", 0.02), ("fedavg", 0.05)):
        fed = FedConfig(num_clients=CLIENTS, local_iters=10,
                        optimizer=optimizer, lr=lr, tau=5,
                        total_rounds=rounds)
        engine = FedEngine(task, fed, device=dev)
        state = engine.init(gen(3))
        noise = gen(1000)
        print(f"\n== {optimizer} (lr={lr}) on {dev} ==")
        for r in range(rounds):
            batches = syn.client_batches(gen(100 + r), x, y, train_idx, 64)
            state, metrics = engine.round(state, batches, generator=noise)
            if r % 5 == 0 or r == rounds - 1:
                with torch.no_grad():
                    acc = task.accuracy(engine.unpack_params(state), test)
                print(f"round {r:3d}  local-loss="
                      f"{float(metrics['loss']):.4f}  test-acc="
                      f"{float(acc):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    main(args.device, args.rounds)
