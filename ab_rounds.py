#!/usr/bin/env python3
"""Two checkouts of this repository against each other on one card, in
turns there and back (A, B, B, A): each kernel entry's host milliseconds
per call, the steady seconds per round of the MLP main path and of the
LM trainer's round, and repeats of one reduced LM card-against-CPU check
with the distance of its h buffer to the band; then that check again
with the CPU side on one thread and the card's deterministic algorithms
(turns B, A).

    python3 ab_rounds.py CHECKOUT_A [CHECKOUT_B]

CHECKOUT_B defaults to the checkout that holds this script.  Each turn is
a process of its own, started in the checkout, that imports the
checkout's own ``chip_smoke.py`` and package and builds its kernels:
``chip_smoke.time_kernels`` for the host milliseconds (its ``host ...
ms per call``), `drive` of the MLP-128 main path for `MLP_ROUNDS`
rounds, ``lm_train`` with `LM_ROUNDS` rounds, and `lm_small_case` of
`SMALL_CASE` `SMALL_REPEATS` times.  Every check keeps its band: a run
that falls outside it is recorded as a failure with its message, and the
run goes on.  Prints one table per measurement, the card's name and power
limit, and writes every turn's record to ``chiprun_out/ab_rounds.json``.
Exits nonzero without a card or if a turn fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MLP_ROUNDS = 12
LM_ROUNDS = 5
SMALL_CASE = "xlstm-1.3b parallel"
SMALL_REPEATS = 2
DET_REPEATS = 3
MARK = "AB_TURN "


def _h_margin(c, want, got, free):
    """Over the h buffer, outside the sLSTM's free coordinates: the
    largest distance to the CPU's value in units of the small band, and
    the count of coordinates past it."""
    import numpy as np
    w, g = want["h"], got["h"]
    r = np.abs(g - w) / (c.SMALL_ATOL + c.SMALL_RTOL * np.abs(w))
    if free is not None and len(free):
        r = r.reshape(w.shape[0], -1).copy()
        r[:, free] = 0.0
    return float(r.max()), int((r > 1.0).sum())


def _small_runs(c, device, repeats):
    """`SMALL_CASE` ``repeats`` times: per run and round the h margin,
    digests of the CPU's and the card's h and params, and any failure
    (of the band, or of the run's other checks: ``"run"``)."""
    import hashlib

    def digest(a):
        return hashlib.sha1(a.tobytes()).hexdigest()[:12]
    runs, orig = [], c.flip_band

    def recording(label, want, got, steps, free=None):
        h_max, h_out = _h_margin(c, want, got, free)
        rnd = {"h_band_ratio": h_max, "h_out": h_out,
               "cpu": digest(want["h"]) + "/" + digest(want["params"]),
               "card": digest(got["h"]) + "/" + digest(got["params"])}
        try:
            orig(label, want, got, steps, free)
        except SystemExit as e:
            rnd["failed"] = str(e)[:300]
        runs[-1].append(rnd)
        return {}
    c.flip_band = recording
    try:
        for _ in range(repeats):
            runs.append([])
            try:
                c.lm_small_case(device, SMALL_CASE)
            except (AssertionError, SystemExit) as e:
                runs[-1].append({"run": str(e)[:300], "failed": True})
    finally:
        c.flip_band = orig
    return runs


def turn_main(mode: str) -> None:
    """One turn, in the current directory's checkout."""
    import contextlib
    import io
    import re
    import warnings
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as c
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.build.build_all()
    rec = {"mode": mode, "checkout": os.getcwd()}
    if mode == "det":
        torch.set_num_threads(1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec["small"] = _small_runs(c, device, DET_REPEATS)
        rec["det_warnings"] = sorted({str(w.message)[:200]
                                      for w in caught})
        print(MARK + json.dumps(rec), flush=True)
        return

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c.time_kernels(device)
    line = re.compile(r"^(.*?) \(([0-9, ]+)\) fp32: device kernel .*"
                      r"host ([0-9.e+-]+) ms per call")
    rec["host_ms"] = {f"{m[1]} ({m[2]})": float(m[3])
                      for m in map(line.match, buf.getvalue().splitlines())
                      if m}

    data = c.make_data(device)
    mlp = c.MLPTask(hidden=c.mlp_mnist.HIDDEN)
    fed = c.FedConfig(strategy="parallel", num_clients=c.CLIENTS,
                      local_iters=c.LOCAL_ITERS, tau=c.TAU, lr=c.SOPHIA_LR,
                      optimizer="fed_sophia")
    with contextlib.redirect_stdout(io.StringIO()):
        *_, secs = c.drive("mlp", mlp, fed, data, MLP_ROUNDS, device,
                           c.expect(sophia_update_batched=MLP_ROUNDS
                                    * c.LOCAL_ITERS))
    rec["mlp_s"] = secs
    rec["mlp_steady_s"] = sum(secs[1:]) / len(secs[1:])
    del data

    c.LM_ROUNDS = LM_ROUNDS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c.lm_train(device)
    m = re.search(r"lm_train: .*steady seconds per round \(rounds [0-9-]+\) "
                  r"([0-9.e+-]+)", buf.getvalue())
    rec["lm_train_steady_s"] = float(m[1])
    rec["small"] = _small_runs(c, device, SMALL_REPEATS)
    print(MARK + json.dumps(rec), flush=True)


def run_turn(checkout: Path, mode: str) -> dict:
    env = dict(os.environ)
    if mode == "det":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--turn", mode], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=1500)
    recs = [json.loads(ln[len(MARK):]) for ln in proc.stdout.splitlines()
            if ln.startswith(MARK)]
    if proc.returncode != 0 or not recs:
        raise SystemExit(f"turn {mode} in {checkout} failed "
                         f"({proc.returncode}):\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return recs[0]


def main() -> None:
    import torch
    args = sys.argv[1:]
    if args[:1] == ["--turn"]:
        turn_main(args[1])
        return
    if not torch.cuda.is_available():
        raise SystemExit("ab_rounds: needs an NVIDIA card")
    paths = [Path(a).resolve() for a in args]
    if len(paths) == 1:
        paths.append(HERE)
    names = "AB"
    order = [(0, "timed"), (1, "timed"), (1, "timed"), (0, "timed"),
             (1, "det"), (0, "det")]
    turns = []
    for j, mode in order:
        rec = run_turn(paths[j], mode)
        rec["name"] = names[j]
        turns.append(rec)
        print(f"turn {names[j]} {mode} done", flush=True)
    for name, path in zip(names, paths):
        print(f"{name} = {path}")
    timed = [t for t in turns if t["mode"] == "timed"]
    labels = list(dict.fromkeys(k for t in timed for k in t["host_ms"]))
    print("host ms per call | " + " | ".join(t["name"] for t in timed))
    for k in labels:
        print(f"{k} | " + " | ".join(
            str(t["host_ms"].get(k, "-")) for t in timed))
    for key in ("mlp_steady_s", "lm_train_steady_s"):
        print(f"{key} | " + " | ".join(f"{t['name']} {t[key]}"
                                       for t in timed))
    for t in turns:
        for i, run in enumerate(t["small"]):
            print(f"{SMALL_CASE} {t['name']} {t['mode']} run {i}: "
                  + "; ".join(
                      f"run check failed: {x['run']}" if "run" in x else
                      f"round {r}: h at {x['h_band_ratio']} of the band, "
                      f"{x['h_out']} past, cpu {x['cpu']}, card {x['card']}"
                      + (" FAILED" if "failed" in x else "")
                      for r, x in enumerate(run)))
        if t.get("det_warnings"):
            print(f"{t['name']} det warnings: {t['det_warnings']}")
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_rounds.json").write_text(json.dumps(turns, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
