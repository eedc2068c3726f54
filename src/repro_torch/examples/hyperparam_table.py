"""Table I of the paper: the effect of the learning rate and of the local
iterations J on Fed-Sophia's test accuracy (FMNIST + CNN); the twin of
the JAX package's ``examples/hyperparam_table.py``.

The grid is the JAX example's: a CNN on synthetic fmnist, 8 clients, 15
rounds, lr 0.01, 0.003 and 0.0005 at J=10, then J = 1, 5 and 10 at lr
0.001.  Each cell runs as the JAX harness's ``run_federated("cnn",
"fmnist", "fed_sophia", ...)`` does (`run_cell`: 8192 images at noise
1.8, a Dirichlet partition at alpha 0.5, ``CNNTask(channels=(8, 16))``,
tau 5, train batches of 64, test batches of 128, the test accuracy after
each round), and the table prints the last round's accuracy.  On the
card every round runs the Sophia kernel's leaf-boundary form (the leaf
route, ``sophia_update_leaves``) once a local step.  Runs on the card;
``--device cpu`` runs on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.hyperparam_table \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as syn
from repro_torch.models.small import CNNTask

#: the table's cells, ``(lr, J)``: the lr sweep at J=10, then the J sweep
#: at lr 0.001
CELLS = ((0.01, 10), (0.003, 10), (0.0005, 10),
         (0.001, 1), (0.001, 5), (0.001, 10))
CLIENTS, ROUNDS = 8, 15
#: the JAX harness's data, model and round settings (its
#: ``benchmarks/common.py``: ``N_SAMPLES``, ``NOISE["fmnist"]``,
#: ``make_task("cnn")``, ``run_federated``'s defaults)
IMAGES, NOISE, ALPHA = 8192, 1.8, 0.5
CHANNELS, TAU, BATCH, TEST_BATCH = (8, 16), 5, 64, 128


def _generator(device, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(salt)


def make_data(dev):
    """The images, labels and per-client ``(train, test)`` index split."""
    x, y = syn.make_image_data(_generator(dev, 0), IMAGES, "fmnist",
                               noise=NOISE)
    part = syn.dirichlet_partition(1, y, CLIENTS, alpha=ALPHA)
    return x, y, syn.train_test_split(part)


def run_cell(lr: float, local_iters: int, dev, data, *,
             rounds: int = ROUNDS,
             hooks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell of the table: ``rounds`` Fed-Sophia rounds of the CNN at
    ``lr`` and ``local_iters`` on `make_data`'s ``data``.  ``hooks``
    (the tests' seam for every draw): ``init(engine)`` the initial
    state, ``batches(r)`` round ``r``'s client batches, ``gumbel(r)``
    its GNB noise (else drawn from a generator on the device),
    ``test_batches`` the test batches.  Returns the test accuracy and
    the loss of each round, the seconds per round (host clock after a
    synchronise) and the engine and its last state."""
    hooks = hooks or {}
    x, y, (train_idx, test_idx) = data
    task = CNNTask(channels=CHANNELS)
    fed = FedConfig(num_clients=CLIENTS, local_iters=local_iters,
                    optimizer="fed_sophia", lr=lr, tau=TAU,
                    total_rounds=rounds, comm=CommConfig())
    engine = FedEngine(task, fed, device=dev)
    state = (hooks["init"](engine) if "init" in hooks
             else engine.init(_generator(dev, 2)))
    test = hooks.get("test_batches") or syn.client_batches(
        _generator(dev, 3), x, y, test_idx, TEST_BATCH)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    accs, losses = [], []
    sync()
    t0 = time.perf_counter()
    for r in range(rounds):
        batches = (hooks["batches"](r) if "batches" in hooks else
                   syn.client_batches(_generator(dev, 100 + r), x, y,
                                      train_idx, BATCH))
        if "gumbel" in hooks:
            state, metrics = engine.round(state, batches,
                                          gumbel=hooks["gumbel"](r))
        else:
            state, metrics = engine.round(
                state, batches, generator=_generator(dev, 1000 + r))
        losses.append(float(metrics["loss"]))
        with torch.no_grad():
            params = engine.unpack_params(state)
            accs.append(float(torch.mean(torch.stack([
                task.accuracy(params, {k: v[c] for k, v in test.items()})
                for c in range(int(test["y"].shape[0]))]))))
    sync()
    return {"accs": accs, "losses": losses,
            "seconds_per_round": (time.perf_counter() - t0) / rounds,
            "engine": engine, "state": state}


def main(argv=None) -> Dict[tuple, Dict[str, Any]]:
    """Print the table; returns each cell's `run_cell` result by ``(lr,
    J)``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.hyperparam_table")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(dev)

    print(f"{'lr':>8} {'J':>3} {'test acc':>9}")
    out = {}
    for lr, J in CELLS:
        res = run_cell(lr, J, dev, data)
        print(f"{lr:>8} {J:>3} {res['accs'][-1]:>9.3f}")
        out[(lr, J)] = res
    return out


if __name__ == "__main__":
    main()
