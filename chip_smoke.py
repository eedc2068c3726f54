#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in this
checkout (into ``build/repro_torch/``), holds each kernel against its
plain PyTorch version on the card, drives the synchronous Fed-Sophia
round at the paper's full MLP width (hidden 128, 32 clients, J=10,
tau=10, batch 64, 60,000 synthetic MNIST-shaped images) on the direct
path and on the compressed comm path (int8 uplink with EF off and on;
bidirectional int8/int8/int4 at participation 0.5, parallel and
sequential), checks small rounds against the same rounds on the CPU,
and times each kernel with CUDA events.  Every path runs with the launch
counts set to 0 just before it and read just after.  Any failure ends
the run with a nonzero exit; nothing is caught.  Without a card it exits
nonzero before printing any result.

The second-to-last line of standard output is the ``{"kernels": [...]}``
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.comm import compressors as tcomp  # noqa: E402
from repro_torch.configs import cnn_mnist, mlp_mnist  # noqa: E402
from repro_torch.configs.base import (COMM_STREAMS, CommConfig,  # noqa: E402
                                      FedConfig)
from repro_torch.core.fed import FedEngine  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sophia_update as tk  # noqa: E402
from repro_torch.kernels.ref import sophia_update_ref  # noqa: E402
from repro_torch.models.small import CNNTask, MLPTask  # noqa: E402

SEED = 0
HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
LR = 3e-3

# the main path: the paper's MNIST experiment at full width
CLIENTS, LOCAL_ITERS, TAU, BATCH, IMAGES = 32, 10, 10, 64, 60_000
MLP_ROUNDS, CNN_ROUNDS, COMM_ROUNDS = 5, 2, 3
SOPHIA_LR, FEDAVG_LR = 0.02, 0.05
MLP_PARAMS, MLP_PACKED = 118_282, (116, 1024)   # MLP hidden 128
CNN_PARAMS, CNN_PACKED = 20_490, (21, 1024)     # CNN channels (16, 32)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: fp32 operations per coordinate of the Sophia update (m: 3, h EMA: 3,
#: h select: 3, decay: 2, max: 1, divide: 1, clip: 2, step: 2)
SOPHIA_OPS = 17
#: fp32 operations per coordinate of the quantize round-trips (quant:
#: divide, add, floor, 2 compares, multiply; uplink adds the delta's
#: subtract and add and the residual's subtract; broadcast also the
#: replica's add)
QUANT_OPS = {"quant": 6, "uplink": 9, "broadcast": 10}
TIMED_LAUNCHES = 200
#: timed calls queued at once, and the sleep (GPU clock cycles, about
#: 50 ms) they queue behind
TIMED_CHUNK = 50
SLEEP_CYCLES = 100_000_000

#: small-round check against the CPU: MLP hidden 16, C=4, J=3, tau=2,
#: B=8, 2 rounds.  Band: cuBLAS and the CPU GEMM sum the matmuls in
#: different orders (a few fp32 ulps per op, compounded over 6 steps)
SMALL = dict(hidden=16, clients=4, iters=3, tau=2, batch=8, rounds=2)
SMALL_RTOL, SMALL_ATOL = 1e-4, 1e-5
#: the comm round's small check: bidir int8/int8/int4, EF on both links,
#: participation 0.5.  Within the band above except at most this many
#: coordinates per buffer, each within one quant step of the streams
#: that write it (a floor(d/s + u) that lands on the other side of an
#: integer: tests/test_torch_comm_round.py)
SMALL_COMM = dict(compressor="int8", error_feedback=True,
                  downlink_compressor="int8", downlink_error_feedback=True,
                  hessian_compressor="int4", participation=0.5)
SMALL_MAX_FLIPS = 16
STEPS_OF = {"params": ("uplink", "downlink"), "m": ("uplink", "downlink"),
            "h": ("uplink", "downlink", "hessian"),
            "comm_ef": ("uplink",), "comm_dn_model": ("downlink",),
            "comm_dn_ef": ("downlink",)}

#: the JAX package's Pallas kernels each CUDA entry point replaces
REPLACES = {
    "sophia_update_batched": "src/repro/kernels/sophia_update.py:100",
    "sophia_update_flat": "src/repro/kernels/sophia_update.py:57",
    "quant_roundtrip_flat": "src/repro/kernels/quantize.py:93",
    "quant_roundtrip_batched": "src/repro/kernels/quantize.py:261",
    "uplink_roundtrip_flat": "src/repro/kernels/quantize.py:177",
    "uplink_roundtrip_batched": "src/repro/kernels/quantize.py:305",
    "broadcast_roundtrip_flat": "src/repro/kernels/quantize.py:133",
    "broadcast_roundtrip_batched": "src/repro/kernels/quantize.py:281",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/"
           + ("sophia_update.cu" if name.startswith("sophia") else
              "quantize.cu") for name in REPLACES}


def gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sync() -> None:
    torch.cuda.synchronize()


def launch_counts() -> dict:
    return {**tk.LAUNCHES, **tq.LAUNCHES}


def reset_launches() -> None:
    tk.reset_launches()
    tq.reset_launches()


def expect(**nonzero) -> dict:
    """The exact launch count of every kernel: 0 unless given."""
    want = {name: 0 for name in REPLACES}
    want.update(nonzero)
    return want


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel checks
def sophia_inputs(shape, device, seed, dtypes=(torch.float32,) * 3,
                  special=False):
    """theta, m, h, g, h_hat on ``device``; theta/m/h stored in
    ``dtypes``.  h, h_hat >= 0 with every 17th h exactly 0 (the eps floor
    and the clip both bite).  Narrow storage scales g and h_hat so that m
    and h leave the fp8 ranges at some coordinates; ``special`` puts NaN
    and inf into h, g and theta."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape)
    m = 0.1 * rs.standard_normal(shape)
    h = np.abs(0.01 * rs.standard_normal(shape))
    h.reshape(-1)[::17] = 0.0
    g = 0.5 * rs.standard_normal(shape)
    hh = np.abs(0.02 * rs.standard_normal(shape))
    if any(dt.itemsize == 1 for dt in dtypes):
        g *= 1e4
        hh *= 1e8
    if special:
        for arr, val in ((h, np.nan), (g, np.inf), (g, -np.inf),
                         (theta, np.nan), (h, np.inf)):
            arr.reshape(-1)[rs.integers(0, arr.size, 64)] = val
    xs = [torch.tensor(x, dtype=torch.float32, device=device)
          for x in (theta, m, h, g, hh)]
    return [x.to(dt) for x, dt in zip(xs[:3], dtypes)] + xs[3:]


def check_kernels(device):
    """Each kernel against its plain version on the card, bitwise
    (compared as raw bytes, NaN included).  Returns the largest
    |kernel - plain| over finite coordinates, per kernel."""
    bf16 = (torch.bfloat16,) * 3
    fp8 = (torch.float32, torch.float8_e4m3fn, torch.float8_e5m2)
    N, R, C = (CLIENTS,) + MLP_PACKED
    cases = [  # (label, entry, shape, dtypes, do_h, special, in place)
        ("batched fp32 do_h=0", "batched", (N, R, C), None, 0, False, False),
        ("batched fp32 do_h=1", "batched", (N, R, C), None, 1, False, False),
        ("batched fp32 in place", "batched", (N, R, C), None, 1, False, True),
        ("batched bf16 theta/m/h", "batched", (N, R, C), bf16, 1, False,
         False),
        ("batched bf16 do_h=0", "batched", (N, R, C), bf16, 0, False, False),
        ("batched e4m3 m + e5m2 h", "batched", (N, R, C), fp8, 1, False,
         False),
        ("batched NaN/inf", "batched", (N, R, C), None, 1, True, False),
        ("batched fp8 NaN/inf", "batched", (N, R, C), fp8, 1, True, False),
        ("flat fp32", "flat", (R, C), None, 1, False, False),
        ("flat fp32 in place", "flat", (R, C), None, 0, False, True),
        ("batched ragged", "batched", (3, 7, 1000), None, 1, False, False),
        ("flat ragged e4m3 m + e5m2 h", "flat", (7, 1000), fp8, 1, False,
         False),
    ]
    fns = {"batched": tk.sophia_update_batched, "flat": tk.sophia_update_flat}
    err = {"sophia_update_batched": 0.0, "sophia_update_flat": 0.0}
    for i, (label, entry, shape, dts, do_h, special, inplace) in enumerate(
            cases):
        ins = sophia_inputs(shape, device, SEED + i,
                            dts or (torch.float32,) * 3, special)
        want = sophia_update_ref(*ins, do_h, lr=LR, **HP)
        key = f"sophia_update_{entry}"
        before = tk.LAUNCHES[key]
        args = [x.clone() for x in ins[:3]] + ins[3:] if inplace else ins
        got = fns[entry](*args, do_h, LR, inplace=inplace, **HP)
        sync()
        if tk.LAUNCHES[key] != before + 1:
            raise SystemExit(f"kernel check {label}: the kernel did not "
                             "launch")
        err[key] = max(err[key], same_bits(label, key, got, want))
        print(f"  {label:30s} {tuple(shape)} bitwise equal")
    return err


def quant_inputs(shape, device, seed, store=torch.float32, shared=True,
                 special=False, qmax=127):
    """theta, other (uplink's start / broadcast's theta), ef stored in
    ``store``; fp32 U[0,1) noise; fp32 row scales of the corrected delta.
    Every 7th row of theta, other and ef is zero (scale 0); the scales
    of rows 1 mod 5 are quartered, so codes pass +-qmax and clip.
    ``other`` is one ``(R, C)`` buffer when ``shared``.  ``special``
    puts NaN into theta and a NaN and an inf into the scales."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape)
    other = rs.standard_normal(shape[-2:] if shared else shape)
    ef = 0.01 * rs.standard_normal(shape)
    for a in (theta, other, ef):
        a[..., ::7, :] = 0.0
    if special:
        theta.reshape(-1)[rs.integers(0, theta.size, 64)] = np.nan
    t = [torch.tensor(a, dtype=torch.float32, device=device).to(store)
         for a in (theta, other, ef)]
    d = (t[0].float() - t[1].float()) + t[2].float()
    scale = torch.amax(d.abs(), -1, keepdim=True) / qmax
    scale[..., 1::5, :] /= 4
    if special:
        scale.reshape(-1)[3] = float("nan")
        scale.reshape(-1)[4] = float("inf")
    noise = torch.tensor(rs.uniform(size=shape), dtype=torch.float32,
                         device=device)
    return t + [noise, scale]


def quant_calls(ins, qmax, flat_row=1):
    """entry-point name -> (kernel call, plain call) over ``ins``: each
    batched entry on the whole stack, each flat entry on one client's
    slice (with the shared operand as it is)."""
    theta, other, ef, u, s = ins
    o1 = other if other.ndim == 2 else other[flat_row]
    r = flat_row
    return {
        "quant_roundtrip_batched": (
            lambda: tq.quant_roundtrip_batched(theta, u, s, qmax=qmax),
            lambda: kref.quant_roundtrip_ref(theta, u, s, qmax=qmax)),
        "quant_roundtrip_flat": (
            lambda: tq.quant_roundtrip_flat(theta[r], u[r], s[r],
                                            qmax=qmax),
            lambda: kref.quant_roundtrip_ref(theta[r], u[r], s[r],
                                             qmax=qmax)),
        "uplink_roundtrip_batched": (
            lambda: tq.uplink_roundtrip_batched(theta, other, ef, u, s,
                                                qmax=qmax),
            lambda: kref.uplink_roundtrip_ref(theta, other, ef, u, s,
                                              qmax=qmax)),
        "uplink_roundtrip_flat": (
            lambda: tq.uplink_roundtrip_flat(theta[r], o1, ef[r], u[r],
                                             s[r], qmax=qmax),
            lambda: kref.uplink_roundtrip_ref(theta[r], o1, ef[r], u[r],
                                              s[r], qmax=qmax)),
        "broadcast_roundtrip_batched": (
            lambda: tq.broadcast_roundtrip_batched(other, theta, ef, u, s,
                                                   qmax=qmax),
            lambda: kref.broadcast_roundtrip_ref(other, theta, ef, u, s,
                                                 qmax=qmax)),
        "broadcast_roundtrip_flat": (
            lambda: tq.broadcast_roundtrip_flat(o1, theta[r], ef[r], u[r],
                                                s[r], qmax=qmax),
            lambda: kref.broadcast_roundtrip_ref(o1, theta[r], ef[r], u[r],
                                                 s[r], qmax=qmax)),
    }


def same_bits(label, name, got, want) -> float:
    """Raises unless ``got`` and ``want`` agree bit for bit (NaN
    included); returns the largest |difference| over finite values."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for k, (g_, w_) in enumerate(zip(got, want)):
        if g_.dtype != w_.dtype or g_.shape != w_.shape:
            raise SystemExit(f"kernel check {label}: {name} output {k} "
                             f"came back {g_.dtype}{tuple(g_.shape)}, plain "
                             f"{w_.dtype}{tuple(w_.shape)}")
        gf, wf = g_.float(), w_.float()
        fin = torch.isfinite(gf) & torch.isfinite(wf)
        if bool(fin.any()):
            worst = max(worst, float((gf - wf).abs()[fin].max()))
        bad = g_.view(torch.uint8) != w_.view(torch.uint8)
        if bool(bad.any()):
            raise SystemExit(f"kernel check {label}: {name} output {k} "
                             f"differs from the plain version (max |diff| "
                             f"{worst}, {int(bad.sum())} bytes differ)")
    return worst


def check_quant_kernels(device):
    """Each quantize entry point against its plain version on the card,
    bitwise: at the main path's shapes; at a ragged (3, 7, 1000) with
    fp32, bf16, e4m3 and e5m2 state, the shared operand shared and
    stacked; with NaN and inf; zero rows and clipped codes in every
    case; and the shared operand against its materialised stack."""
    N, (R, C) = CLIENTS, MLP_PACKED
    cases = [  # (label, shape, store, shared, special, qmax)
        ("MLP-128 x 32 fp32 int8", (N, R, C), torch.float32, True, False,
         127),
        ("MLP-128 x 16 fp32 int4", (N // 2, R, C), torch.float32, True,
         False, 7),
        ("MLP-128 x 32 fp32 stacked", (N, R, C), torch.float32, False,
         False, 127),
    ]
    for store in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
                  torch.float8_e5m2):
        for shared in (True, False):
            cases.append((f"ragged {str(store)[6:]} "
                          f"{'shared' if shared else 'stacked'}",
                          (3, 7, 1000), store, shared, False, 7))
    for store in (torch.float32, torch.float8_e4m3fn, torch.float8_e5m2):
        cases.append((f"ragged {str(store)[6:]} NaN/inf", (3, 7, 1000),
                      store, True, True, 127))
    err = {name: 0.0 for name in tq.LAUNCHES}
    for i, (label, shape, store, shared, special, qmax) in enumerate(cases):
        ins = quant_inputs(shape, device, SEED + 40 + i, store, shared,
                           special, qmax)
        for name, (kern, plain) in quant_calls(ins, qmax).items():
            before = tq.LAUNCHES[name]
            got = kern()
            sync()
            if tq.LAUNCHES[name] != before + 1:
                raise SystemExit(f"kernel check {label}: {name} did not "
                                 "launch")
            err[name] = max(err[name], same_bits(label, name, got, plain()))
        print(f"  {label:30s} {shape} all six entry points bitwise equal")
    # the shared (R, C) operand against the same model materialised per
    # client: one and the same computation
    theta, other, ef, u, s = quant_inputs((N, R, C), device, SEED + 90)
    stack = other.expand(N, R, C).contiguous()
    same_bits("shared start", "uplink_roundtrip_batched",
              tq.uplink_roundtrip_batched(theta, other, ef, u, s, qmax=127),
              tq.uplink_roundtrip_batched(theta, stack, ef, u, s, qmax=127))
    same_bits("shared theta", "broadcast_roundtrip_batched",
              tq.broadcast_roundtrip_batched(other, theta, ef, u, s,
                                             qmax=127),
              tq.broadcast_roundtrip_batched(stack, theta, ef, u, s,
                                             qmax=127))
    sync()
    print("  shared (R, C) operand == materialised stack, bitwise")
    return err


def fp8_overflow_rule(device):
    """What ``Tensor.to(float8_*)`` stores past the fp8 range, on the
    card; the kernel checks above hold the kernel to the same."""
    vals = torch.tensor([448.0, 464.0, 465.0, 480.0, 1e6, float("inf"),
                         57344.0, 61439.0, 61440.0, float("nan")],
                        device=device)
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        got = vals.to(dt).float().tolist()
        print(f"  {str(dt):22s} "
              + "  ".join(f"{v:g}->{o:g}" for v, o in
                          zip(vals.tolist(), got)))


# --------------------------------------------------------------- main path
def make_data(device):
    x, y = syn.make_image_data(gen(device, SEED), IMAGES, "mnist", noise=1.3)
    part = syn.dirichlet_partition(SEED + 1, y, CLIENTS, alpha=0.5)
    train_idx, _ = syn.train_test_split(part)
    return x, y, train_idx


def run_rounds(task, fed, data, rounds, device):
    """``rounds`` rounds through `FedEngine.round`; returns the final
    state, the per-round losses and host seconds per round (each timed
    around work that ends in a device synchronise)."""
    x, y, train_idx = data
    engine = FedEngine(task, fed, device=device)
    state = engine.init(gen(device, SEED + 3))
    noise = gen(device, SEED + 1000)
    losses, secs = [], []
    for r in range(rounds):
        batches = syn.client_batches(gen(device, SEED + 100 + r), x, y,
                                     train_idx, BATCH)
        sync()
        t0 = time.perf_counter()
        state, metrics = engine.round(state, batches, generator=noise)
        sync()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    params = engine.unpack_params(state)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise SystemExit("non-finite parameters after the run")
    return engine, state, losses, secs


def drive(label, task, fed, data, rounds, device, want):
    """One path of the main run, with every launch count set to 0 just
    before it and read just after.  ``want``: the exact launch count of
    each kernel on this path."""
    reset_launches()
    engine, state, losses, secs = run_rounds(task, fed, data, rounds,
                                             device)
    got = launch_counts()
    print(f"{label}: losses {losses}")
    print(f"{label}: seconds per round {secs}")
    print(f"{label}: launches {got}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    return engine, state, losses, secs


def main_path(device):
    """The main path's runs; returns each kernel's launch count summed
    over the paths (each read just after its own path), and the steady
    seconds per round of each path."""
    data = make_data(device)
    print(f"data: {IMAGES} images {tuple(data[0].shape)} on {device}, "
          f"{CLIENTS} clients x {data[2].shape[1]} train samples")
    mlp = MLPTask(hidden=mlp_mnist.HIDDEN)
    base = dict(num_clients=CLIENTS, local_iters=LOCAL_ITERS, tau=TAU,
                lr=SOPHIA_LR, optimizer="fed_sophia")
    sophia = FedConfig(strategy="parallel", **base)
    launches = {name: 0 for name in REPLACES}
    steady = {}

    def record(label, secs):
        for k, v in launch_counts().items():
            launches[k] += v
        steady[label] = (sum(secs[1:]) / len(secs[1:]) if len(secs) > 1
                         else secs[0])

    torch.cuda.reset_peak_memory_stats()
    label = "fed_sophia parallel MLP-128"
    engine, state, losses, secs = drive(
        label, mlp, sophia, data, MLP_ROUNDS, device,
        expect(sophia_update_batched=MLP_ROUNDS * LOCAL_ITERS))
    record(label, secs)
    packed = tuple(state["client_opt"].m.shape[1:])
    if engine.num_params(state) != MLP_PARAMS or packed != MLP_PACKED:
        raise SystemExit(f"MLP-128 packs {engine.num_params(state)} "
                         f"parameters as {packed}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"fed_sophia local loss did not fall: {losses}")
    print(f"{label}: steady seconds per round (mean of rounds "
          f"1-{MLP_ROUNDS - 1}) {steady[label]}; peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    profile_round(engine, state, data, device, steady[label])

    fedavg = FedConfig(num_clients=CLIENTS, local_iters=LOCAL_ITERS,
                       lr=FEDAVG_LR, optimizer="fedavg", strategy="parallel")
    label = "fedavg parallel MLP-128"
    _, _, _, secs = drive(label, mlp, fedavg, data, MLP_ROUNDS, device,
                          expect())
    record(label, secs)

    label = "fed_sophia sequential MLP-128"
    _, _, _, secs = drive(label, mlp,
                          FedConfig(strategy="sequential", **base), data, 1,
                          device,
                          expect(sophia_update_flat=CLIENTS * LOCAL_ITERS))
    record(label, secs)

    cnn = CNNTask(channels=cnn_mnist.CHANNELS)
    label = "fed_sophia parallel CNN-(16,32)"
    engine, state, _, secs = drive(
        label, cnn, sophia, data, CNN_ROUNDS, device,
        expect(sophia_update_batched=CNN_ROUNDS * LOCAL_ITERS))
    record(label, secs)
    packed = tuple(state["client_opt"].m.shape[1:])
    if engine.num_params(state) != CNN_PARAMS or packed != CNN_PACKED:
        raise SystemExit(f"CNN packs {engine.num_params(state)} parameters "
                         f"as {packed}")

    # the compressed comm path, at the same width
    J, R = LOCAL_ITERS, COMM_ROUNDS
    S = CLIENTS // 2
    bidir = dict(compressor="int8", downlink_compressor="int8",
                 hessian_compressor="int4", participation=0.5)
    phases = [  # (label, strategy, CommConfig kwargs, rounds, launches)
        ("uplink-int8", "parallel", dict(compressor="int8"), R,
         expect(sophia_update_batched=J * R, quant_roundtrip_batched=R)),
        ("uplink-int8-ef", "parallel",
         dict(compressor="int8", error_feedback=True), R,
         expect(sophia_update_batched=J * R, uplink_roundtrip_batched=R)),
        ("bidir-int8", "parallel", bidir, R,
         expect(broadcast_roundtrip_batched=R, sophia_update_batched=J * R,
                quant_roundtrip_batched=2 * R, quant_roundtrip_flat=R)),
        ("bidir-int8-ef sequential", "sequential",
         dict(bidir, error_feedback=True), 1,
         expect(broadcast_roundtrip_flat=S, sophia_update_flat=S * J,
                uplink_roundtrip_flat=S, quant_roundtrip_flat=S + 1)),
    ]
    for label, strategy, comm_kw, rounds, want in phases:
        fed = FedConfig(strategy=strategy, comm=CommConfig(**comm_kw),
                        **base)
        engine, state, losses, secs = drive(label, mlp, fed, data, rounds,
                                            device, want)
        record(label, secs)
        if rounds > 1 and not losses[-1] < losses[0]:
            raise SystemExit(f"{label}: fed_sophia local loss did not "
                             f"fall: {losses}")
        print(f"{label}: steady seconds per round {steady[label]}")
        if label == "bidir-int8":
            profile_round(engine, state, data, device, steady[label])
    return launches, steady


# ------------------------------------------------------- small-round check
def small_setup():
    """The small checks' task, images, labels, client partition and
    initial weights, on the CPU."""
    task = MLPTask(hidden=SMALL["hidden"])
    rs = np.random.default_rng(SEED)
    x = torch.tensor(rs.standard_normal((256, 28, 28, 1)), dtype=torch.float32)
    y = torch.tensor(rs.integers(0, 10, 256))
    part = syn.dirichlet_partition(SEED, y, SMALL["clients"], alpha=0.5)
    return task, x, y, part, task.init(gen("cpu", SEED))


def small_round_check(device):
    """Two small rounds on the card against the same rounds on the CPU
    (plain versions there): same initial weights, batches and GNB noise."""
    s = SMALL
    task, x, y, part, init = small_setup()
    for strategy in ("parallel", "sequential"):
        fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                        tau=s["tau"], lr=0.02, strategy=strategy)
        out = {}
        for dev in ("cpu", device):
            engine = FedEngine(task, fed, device=dev)
            state = engine.init_from_params(
                {k: v.to(dev) for k, v in init.items()})
            losses = []
            for r in range(s["rounds"]):
                b = syn.client_batches(gen("cpu", 10 + r), x, y, part,
                                       s["batch"])
                noise = torch.tensor(small_noise(r, s), device=dev)
                state, metrics = engine.round(
                    state, {k: v.to(dev) for k, v in b.items()},
                    gumbel=noise)
                losses.append(float(metrics["loss"]))
            out[str(dev)] = (losses, engine.pack_state(state)["params"].cpu(),
                             state["client_opt"].m.cpu(),
                             state["client_opt"].h.cpu())
        cpu, card = out["cpu"], out[str(device)]
        for what, a, b in zip(("loss", "params", "m", "h"), card, cpu):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=SMALL_RTOL,
                atol=SMALL_ATOL, err_msg=f"small {strategy} round: {what}")
        print(f"small {strategy} round: card agrees with the CPU within "
              f"rtol={SMALL_RTOL} atol={SMALL_ATOL}; losses card "
              f"{card[0]} cpu {cpu[0]}")


def small_noise(r, s):
    """The GNB gumbel noise of small round ``r``, ``(C, J, B, 10)``."""
    u = np.random.default_rng(SEED + 500 + r).uniform(
        size=(s["clients"], s["iters"], s["batch"], 10))
    return (-np.log(-np.log(np.maximum(u, 1e-30)))).astype(np.float32)


def small_comm_noise(engine, state, r, s):
    """The comm path's injected random inputs of small round ``r``:
    the participants and each quantized stream's U[0, 1) noise by client
    id, from numpy."""
    rt = engine.runtime_for(state["params"])
    rs = np.random.default_rng(SEED + 700 + r)
    C = s["clients"]
    S = engine.fed.comm.num_participants(C)
    noise = {"participants": np.sort(rs.choice(C, S, replace=False))}
    for stream, spec in (("uplink", rt.spec), ("downlink", rt.spec_dn),
                         ("hessian", rt.spec_h)):
        noise[stream] = rs.uniform(size=(C, spec.rows, spec.cols))
    noise["server_hessian"] = rs.uniform(size=(rt.spec_h.rows,
                                               rt.spec_h.cols))
    return {k: (v if k == "participants" else v.astype(np.float32))
            for k, v in noise.items()}


def state_buffers(state) -> dict:
    """name -> numpy of every resident buffer of a comm-path state (the
    params flattened in sorted-key order)."""
    st = convert.state_to_numpy(state)
    out = {"params": np.concatenate([v.reshape(-1) for _, v in
                                     sorted(st["params"].items())]),
           "m": st["client_opt"]["m"], "h": st["client_opt"]["h"]}
    out.update({k: st[k] for k in convert.COMM_KEYS if k in st})
    return out


class ScaleProbe:
    """Records the largest row scale each stream's compressor computes
    while active (a stream whose config view equals another's records
    into both)."""

    def __init__(self, comm):
        self.comm, self.steps = comm, {}

    def __enter__(self):
        self.orig = orig = tcomp.StochasticQuant.scales
        probe = self

        def scales(comp, flat):
            out = orig(comp, flat)
            for name in COMM_STREAMS:
                if comp.cfg == probe.comm.stream(name):
                    probe.steps[name] = max(probe.steps.get(name, 0.0),
                                            float(out.max()))
            return out
        tcomp.StochasticQuant.scales = scales
        return self

    def __exit__(self, *exc):
        tcomp.StochasticQuant.scales = self.orig


def small_comm_round_check(device):
    """Two small bidir rounds on the card against the same rounds on the
    CPU: same weights, batches, GNB noise, participants and quantization
    noise.  Every coordinate of params, m, h, EF residuals and replicas
    within the small band, except at most SMALL_MAX_FLIPS per buffer,
    each within one quant step of its streams."""
    s = SMALL
    task, x, y, part, init = small_setup()
    for strategy in ("parallel", "sequential"):
        fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                        tau=s["tau"], lr=0.02, strategy=strategy,
                        comm=CommConfig(**SMALL_COMM))
        runs = {str(dev): FedEngine(task, fed, device=dev)
                for dev in ("cpu", device)}
        states = {k: e.init_from_params({n: v.to(e.device)
                                         for n, v in init.items()})
                  for k, e in runs.items()}
        flips = []
        for r in range(s["rounds"]):
            b = syn.client_batches(gen("cpu", 10 + r), x, y, part,
                                   s["batch"])
            cnoise = small_comm_noise(runs["cpu"], states["cpu"], r, s)
            losses, steps = {}, {}
            for key, engine in runs.items():
                dev = engine.device
                with ScaleProbe(fed.comm) as probe:
                    states[key], metrics = engine.round(
                        states[key], {k: v.to(dev) for k, v in b.items()},
                        gumbel=torch.tensor(small_noise(r, s), device=dev),
                        comm_noise=cnoise)
                losses[key] = float(metrics["loss"])
                for k, v in probe.steps.items():
                    steps[k] = max(steps.get(k, 0.0), v)
            np.testing.assert_allclose(
                losses[str(device)], losses["cpu"], rtol=SMALL_RTOL,
                atol=SMALL_ATOL, err_msg=f"small comm {strategy}: loss")
            want = state_buffers(states["cpu"])
            got = state_buffers(states[str(device)])
            counts = {}
            for name, w in want.items():
                g = got[name]
                band = SMALL_ATOL + SMALL_RTOL * np.abs(w)
                diff = np.abs(g - w)
                out = diff > band
                step = sum(steps.get(st, 0.0) for st in STEPS_OF[name])
                counts[name] = int(out.sum())
                if counts[name] > SMALL_MAX_FLIPS or not np.all(
                        diff[out] <= step + band[out]):
                    raise SystemExit(
                        f"small comm {strategy} round {r}: {name} has "
                        f"{counts[name]} coordinates outside the band, "
                        f"largest {float(diff.max())}, step {step}")
            flips.append(counts)
        print(f"small comm {strategy} rounds (bidir, EF on, S=2 of 4): card "
              f"agrees with the CPU within rtol={SMALL_RTOL} "
              f"atol={SMALL_ATOL} but for coordinates one quant step off "
              f"(flips per buffer, rounds 1-2): {flips}")


# ------------------------------------------------------------------ timing
def host_ms(fn, launches=TIMED_LAUNCHES) -> float:
    """Host milliseconds per call, back to back, synchronised at the end:
    what a caller that launches one update after another pays."""
    sync()
    t0 = time.perf_counter()
    for i in range(launches):
        fn(i)
    sync()
    return (time.perf_counter() - t0) * 1e3 / launches


def time_ms(fn, launches=TIMED_LAUNCHES, chunk=TIMED_CHUNK,
            warmup=20) -> float:
    """Device milliseconds per call by CUDA events.  Each chunk of calls
    is queued behind a sleep kernel that outlasts its enqueue, so the
    device runs the chunk back to back whatever the host's pace; the
    events bracket the chunk alone.  Raises if a chunk took longer to
    enqueue than the sleep covers (the reading would include host gaps)."""
    for i in range(warmup):
        fn(i)
    sync()
    total = 0.0
    for c in range(0, launches, chunk):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        slept = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for i in range(c, c + chunk):
            fn(i)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        sync()
        sleep_ms = slept.elapsed_time(start)
        if enqueue_ms >= sleep_ms:
            raise SystemExit(f"timing: a chunk took {enqueue_ms} ms to "
                             f"enqueue, the sleep covers {sleep_ms} ms")
        total += start.elapsed_time(stop)
    return total / launches


def bound(ins, outs_like, ops_per_coord):
    """Least time for one call: the larger of bytes over HBM rate and
    fp32 operations over the fp32 peak.  Each input read once, each
    output written once (a shared operand counts once)."""
    nbytes = sum(x.numel() * x.element_size() for x in ins)
    nbytes += sum(x.numel() * x.element_size() for x in outs_like)
    ops = ops_per_coord * outs_like[0].numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_pair(name, kern, plain, ins, outs_like, ops_per_coord):
    """Device ms of kernel and plain version in turns (plain, kernel,
    kernel, plain), host ms per kernel call, and the bound."""
    p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                      time_ms(plain))
    host = host_ms(kern)
    b_ms, b_by, nbytes = bound(ins, outs_like, ops_per_coord)
    k = (k1 + k2) / 2
    shape = list(outs_like[0].shape)
    print(f"{name} {tuple(shape)} fp32: device kernel {k1} / {k2} ms, "
          f"plain {p1} / {p2} ms, bound {b_ms} ms ({b_by}, {nbytes} "
          f"bytes); kernel at {nbytes / k / 1e9} TB/s, {b_ms / k} of the "
          f"bound; host {host} ms per call")
    return dict(ms=k, plain_ms=(p1 + p2) / 2, host_ms=host, bound_ms=b_ms,
                bound_by=b_by, shape=shape)


def time_kernels(device):
    """Every kernel and its plain version at the main path's shapes,
    fp32.  A flat entry walks the 32 client slices of a stack in turn,
    so each launch finds its buffers outside the 50 MB L2, as the
    sequential strategy does; the batched entries run on the whole stack
    (32 clients; 16 for the downlink of the bidir path, where half the
    clients take part)."""
    N, R, C = (CLIENTS,) + MLP_PACKED
    ins = sophia_inputs((N, R, C), device, SEED + 99)
    lr = torch.tensor(LR)
    out = {
        "sophia_update_batched": time_pair(
            "sophia_update_batched",
            lambda i: tk.sophia_update_batched(*ins, 1, lr, **HP),
            lambda i: sophia_update_ref(*ins, 1, lr=lr, **HP),
            ins, ins[:3], SOPHIA_OPS),
        "sophia_update_flat": time_pair(
            "sophia_update_flat",
            lambda i: tk.sophia_update_flat(*(x[i % N] for x in ins), 1, lr,
                                            **HP),
            lambda i: sophia_update_ref(*(x[i % N] for x in ins), 1, lr=lr,
                                        **HP),
            [x[0] for x in ins], [x[0] for x in ins[:3]], SOPHIA_OPS),
    }
    del ins
    q = 127
    th, sv, ef, u, s = quant_inputs((N, R, C), device, SEED + 98,
                                    shared=True, qmax=q)
    st = th.flip(0).contiguous()      # per-client starts / replicas
    h = N // 2
    out["quant_roundtrip_batched"] = time_pair(
        "quant_roundtrip_batched",
        lambda i: tq.quant_roundtrip_batched(th, u, s, qmax=q),
        lambda i: kref.quant_roundtrip_ref(th, u, s, qmax=q),
        [th, u, s], [th], QUANT_OPS["quant"])
    time_pair("quant_roundtrip_batched (hessian, S=16)",
              lambda i: tq.quant_roundtrip_batched(th[:h], u[:h], s[:h],
                                                   qmax=7),
              lambda i: kref.quant_roundtrip_ref(th[:h], u[:h], s[:h],
                                                 qmax=7),
              [th[:h], u[:h], s[:h]], [th[:h]], QUANT_OPS["quant"])
    out["uplink_roundtrip_batched"] = time_pair(
        "uplink_roundtrip_batched",
        lambda i: tq.uplink_roundtrip_batched(th, sv, ef, u, s, qmax=q),
        lambda i: kref.uplink_roundtrip_ref(th, sv, ef, u, s, qmax=q),
        [th, sv, ef, u, s], [th, th], QUANT_OPS["uplink"])
    out["broadcast_roundtrip_batched"] = time_pair(
        "broadcast_roundtrip_batched",
        lambda i: tq.broadcast_roundtrip_batched(sv, st[:h], ef[:h], u[:h],
                                                 s[:h], qmax=q),
        lambda i: kref.broadcast_roundtrip_ref(sv, st[:h], ef[:h], u[:h],
                                               s[:h], qmax=q),
        [sv, st[:h], ef[:h], u[:h], s[:h]], [st[:h], st[:h]],
        QUANT_OPS["broadcast"])
    out["quant_roundtrip_flat"] = time_pair(
        "quant_roundtrip_flat",
        lambda i: tq.quant_roundtrip_flat(th[i % N], u[i % N], s[i % N],
                                          qmax=q),
        lambda i: kref.quant_roundtrip_ref(th[i % N], u[i % N], s[i % N],
                                           qmax=q),
        [th[0], u[0], s[0]], [th[0]], QUANT_OPS["quant"])
    out["uplink_roundtrip_flat"] = time_pair(
        "uplink_roundtrip_flat",
        lambda i: tq.uplink_roundtrip_flat(th[i % N], st[i % N], ef[i % N],
                                           u[i % N], s[i % N], qmax=q),
        lambda i: kref.uplink_roundtrip_ref(th[i % N], st[i % N], ef[i % N],
                                            u[i % N], s[i % N], qmax=q),
        [th[0], st[0], ef[0], u[0], s[0]], [th[0], th[0]],
        QUANT_OPS["uplink"])
    out["broadcast_roundtrip_flat"] = time_pair(
        "broadcast_roundtrip_flat",
        lambda i: tq.broadcast_roundtrip_flat(sv, st[i % N], ef[i % N],
                                              u[i % N], s[i % N], qmax=q),
        lambda i: kref.broadcast_roundtrip_ref(sv, st[i % N], ef[i % N],
                                               u[i % N], s[i % N], qmax=q),
        [sv, st[0], ef[0], u[0], s[0]], [st[0], st[0]],
        QUANT_OPS["broadcast"])
    return out


def profile_round(engine, state, data, device, steady_s):
    """One more steady round of the main path under `torch.profiler`:
    device time by kernel, and the device's busy share of the
    unprofiled steady round time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, y, train_idx = data
    batches = syn.client_batches(gen(device, SEED + 200), x, y, train_idx,
                                 BATCH)
    noise = gen(device, SEED + 2000)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.round(state, batches, generator=noise)
        sync()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        raise SystemExit("profile: the profiler recorded no device time")
    busy_us = sum(t for t, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    print(f"profiled round: {n_kernels} device activities, device busy "
          f"{busy_us} us; wall {wall * 1e6} us under the profiler, "
          f"busy share of the unprofiled steady round "
          f"{busy_us / (steady_s * 1e6)}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, n) in top:
        print(f"  {t:10.1f} us  {n:5d}x  {name[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA card")
    device = torch.device("cuda", 0)
    print(card_info())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    for info in build.build_all().values():
        print(f"built {info.path.name} in {info.seconds:.2f} s")
        for line in info.ptxas:
            print(f"  {line}")
    print(f"build phase {time.perf_counter() - t0:.2f} s")

    print("fp8 stores of Tensor.to on the card:")
    fp8_overflow_rule(device)
    print("kernels against their plain versions on the card:")
    err = check_kernels(device)
    err.update(check_quant_kernels(device))

    small_round_check(device)
    small_comm_round_check(device)
    launches, steady = main_path(device)
    print(f"steady seconds per round by path: {json.dumps(steady)}")
    timing = time_kernels(device)

    kernels = []
    for name in REPLACES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "host_ms": t["host_ms"],
            "shape": t["shape"], "bitwise_vs_plain": True})
    print("library_ms: none; no single PyTorch call computes the Sophia "
          "update or a stochastic-rounding quantize round-trip "
          "(fake_quantize_per_channel_affine rounds to nearest, without "
          "noise)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
