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
sequential; top-k and SignSGD with majority vote on the uplink;
bidirectional SignSGD/top-k/int4 at participation 0.5, parallel and
sequential), through the virtual-time scheduler (sync, semisync with and
without chunked dispatch, async, under a straggler profile) and the
adversarial fleet (sign-flip with trimmed mean and coordinate median on
a Dirichlet(0.1) partition, random wires into a trimmed mean on the
comm path, a scale attack under norm-clip in semisync), and the pytree
Sophia step; checks small rounds and scheduler runs against the same
on the CPU, and times each kernel with CUDA events.  Every path runs
with the launch counts set to 0 just before it and read just after.
Any failure ends the run with a nonzero exit; nothing is caught.
Without a card it exits nonzero before printing any result.

The second-to-last line of standard output is the ``{"kernels": [...]}``
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.comm import accounting as tacc  # noqa: E402
from repro_torch.comm import compressors as tcomp  # noqa: E402
from repro_torch.comm import flat as tflat  # noqa: E402
from repro_torch.configs import cnn_mnist, mlp_mnist  # noqa: E402
from repro_torch.configs.base import (COMM_STREAMS, CommConfig,  # noqa: E402
                                      FedConfig, RobustConfig,
                                      SchedConfig)
from repro_torch.core import sophia as tsophia  # noqa: E402
from repro_torch.core.fed import FedEngine  # noqa: E402
from repro_torch.core.gnb import gnb_estimate  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import robust_agg as trobust  # noqa: E402
from repro_torch.kernels import sophia_update as tk  # noqa: E402
from repro_torch.kernels import stale_accum as tstale  # noqa: E402
from repro_torch.kernels.ref import sophia_update_ref  # noqa: E402
from repro_torch.models.small import (CNNTask, MLPTask,  # noqa: E402
                                      gumbel_noise)
from repro_torch.robust.aggregators import resolve, trim_count  # noqa: E402
from repro_torch.sched.scheduler import VirtualScheduler  # noqa: E402

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
#: fp32 instructions per second that are not FMAs (add, multiply,
#: compare, select): the FLOP rate counts an FMA as two operations, and
#: the kernels are built with -fmad=false, so each operation they count
#: is one instruction at half that rate
FP32_OPS_PER_S = FP32_FLOPS / 2
#: fp32 operations per coordinate of the Sophia update (m: 3, h EMA: 3,
#: h select: 3, decay: 2, max: 1, divide: 1, clip: 2, step: 2)
SOPHIA_OPS = 17
#: fp32 operations per coordinate of the quantize round-trips (quant:
#: divide, add, floor, 2 compares, multiply; uplink adds the delta's
#: subtract and add and the residual's subtract; broadcast also the
#: replica's add)
QUANT_OPS = {"quant": 6, "uplink": 9, "broadcast": 10}
#: fp32 operations per coordinate of the biased compressors' kernels
#: (sign: two compares, copysign, multiply; threshold: abs, compare,
#: select)
BIASED_OPS = {"sign": 4, "topk": 3}
#: the state dtypes the kernels load and store
STORES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
          torch.float8_e5m2)
#: top-k's ratio on the main path, as the JAX package's comm benchmark
#: runs it (benchmarks/run.py)
TOPK_RATIO = 0.05
#: words in the device-activity names of the compressors' kernels and
#: of top-k's selection (torch.topk's sort and select kernels)
COMM_KERNEL_WORDS = ("roundtrip", "per_client", "topk", "sort", "radix",
                     "select")
#: the scheduler's and the adversarial fleet's phases, as the JAX
#: package's benchmark runs them at paper scale (benchmarks/run.py:
#: fig_sched, fig_robust): int8 uplinks, a straggler profile, 20%
#: byzantine clients on a Dirichlet(0.1) partition
STRAGGLER = dict(latency_profile="straggler", straggler_frac=0.25,
                 straggler_slowdown=10.0)
BYZ = dict(attack_fraction=0.2)
DIRICHLET_ALPHA = 0.1
#: norm-clip's bound in the semisync phase: below the wires' norms, so
#: it clips every arrival
CLIP_NORM = 0.5
SCHED_EVENTS = {"sync": 2, "semisync": 6, "chunk8": 3, "async": 24,
                "normclip": 3}
ROBUST_ROUNDS = 2


def stale_ops(K: int) -> int:
    """fp32 operations per output coordinate of the stale accumulate: a
    multiply and an add per arrival, the final scale."""
    return 2 * K + 1


def robust_ops(K: int, trim: int) -> int:
    """fp32 operations per output coordinate of the robust combine: the
    scale multiply per arrival, a select and a compare per arrival in
    each of the 2*trim passes, the survivor-weight select, the multiply
    and the two adds of the sums per arrival, the divide."""
    return K + 2 * trim * K * 2 + 4 * K + 1


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
#: the biased bidir phase and small check: SignSGD uplink, top-k
#: downlink, int4 hessian stream, EF auto (on for both links).  A flip
#: there moves a coordinate by at most top-k's threshold, or twice
#: SignSGD's scale.  The small check starts each round on the card from
#: the CPU's state: SignSGD's mean of S=2 clients has a few distinct
#: magnitudes, so the next downlink delta is a sea of near-ties at
#: top-k's threshold, split by the last ulp of theta; a 1e-6 nudge of
#: the weights moves thousands of coordinates across it in the next
#: round (measured on the CPU), a property of the configuration that
#: the check must not compound
BIASED_BIDIR = dict(compressor="signsgd", downlink_compressor="topk",
                    hessian_compressor="int4", topk_ratio=TOPK_RATIO,
                    participation=0.5)
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
    "sign_roundtrip_flat": "src/repro/kernels/quantize.py:210",
    "sign_roundtrip_batched": "src/repro/kernels/quantize.py:335",
    "topk_threshold_flat": "src/repro/kernels/quantize.py:234",
    "topk_threshold_batched": "src/repro/kernels/quantize.py:360",
    "sophia_fused_step": "src/repro/kernels/ops.py:32",
    "stale_accum_flat": "src/repro/kernels/stale_accum.py:61",
    "robust_agg_flat": "src/repro/kernels/robust_agg.py:74",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/"
           + ("sophia_update.cu" if name.startswith("sophia") else
              "stale_accum.cu" if name.startswith("stale") else
              "robust_agg.cu" if name.startswith("robust") else
              "quantize.cu") for name in REPLACES}


def gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sync() -> None:
    torch.cuda.synchronize()


#: the launch counters of every kernel wrapper
COUNTERS = (tk, tq, tstale, trobust, ops)


def launch_counts() -> dict:
    out = {}
    for mod in COUNTERS:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    for mod in COUNTERS:
        mod.reset_launches()


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
    for store in STORES:
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


def biased_inputs(shape, device, seed, store=torch.float32, special=False):
    """x ``(N, R, C)`` stored in ``store`` and one fp32 scalar per client:
    its mean |x| (SignSGD's scale, used as the threshold too, so about
    half of each client survives), rounded to ``store`` so that the 16
    ties planted per client at +-scalar are exact; the last client's
    scalar is 0.  ``special`` puts NaN, +-0 and +-inf into every
    client."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    flat = x.reshape(shape[0], -1)
    v = torch.tensor(np.abs(flat).mean(-1)).to(store).float().numpy()
    v[-1] = 0.0
    for n in range(shape[0]):
        pos = rs.choice(flat.shape[1], 22, replace=False)
        flat[n, pos[:16]] = v[n] * np.array([1, -1] * 8, np.float32)
        if special:
            flat[n, pos[16:]] = [np.nan, -np.nan, 0.0, -0.0, np.inf,
                                 -np.inf]
    return (torch.tensor(x, device=device).to(store),
            torch.tensor(v, device=device))


def biased_calls(x, v, flat_row=1):
    """entry-point name -> (kernel call, plain call): each batched entry
    on the whole stack, each flat entry on one client's slice."""
    r = flat_row
    return {
        "sign_roundtrip_batched": (
            lambda: tq.sign_roundtrip_batched(x, v),
            lambda: kref.sign_roundtrip_ref(x, v)),
        "sign_roundtrip_flat": (
            lambda: tq.sign_roundtrip_flat(x[r], v[r]),
            lambda: kref.sign_roundtrip_ref(x[r], v[r])),
        "topk_threshold_batched": (
            lambda: tq.topk_threshold_batched(x, v),
            lambda: kref.topk_threshold_ref(x, v)),
        "topk_threshold_flat": (
            lambda: tq.topk_threshold_flat(x[r], v[r]),
            lambda: kref.topk_threshold_ref(x[r], v[r])),
    }


def check_biased_kernels(device):
    """The sign and top-k threshold entry points against their plain
    versions on the card, bitwise: at a 32- and a 16-client MLP-128 stack
    (the flat entries on one client's (116, 1024) slice) and at a ragged
    (3, 7, 1000) over fp32, bf16, e4m3 and e5m2, with and without NaN,
    +-0 and +-inf; ties at every client's threshold and one client with
    scalar 0 in each case."""
    N, (R, C) = CLIENTS, MLP_PACKED
    cases = [("MLP-128 x 32 fp32", (N, R, C), torch.float32, False),
             ("MLP-128 x 16 fp32 NaN/inf", (N // 2, R, C), torch.float32,
              True)]
    for store in STORES:
        for special in (False, True):
            cases.append((f"ragged {str(store)[6:]}"
                          + (" NaN/0/inf" if special else ""),
                          (3, 7, 1000), store, special))
    err = {}
    for i, (label, shape, store, special) in enumerate(cases):
        x, v = biased_inputs(shape, device, SEED + 120 + i, store, special)
        for name, (kern, plain) in biased_calls(x, v).items():
            before = tq.LAUNCHES[name]
            got = kern()
            sync()
            if tq.LAUNCHES[name] != before + 1:
                raise SystemExit(f"kernel check {label}: {name} did not "
                                 "launch")
            err[name] = max(err.get(name, 0.0),
                            same_bits(label, name, got, plain()))
        print(f"  {label:30s} {shape} all four biased entry points "
              "bitwise equal")
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


def agg_inputs(K, device, seed, store=torch.float32, special=False):
    """A ``(K, 116, 1024)`` arrival stack stored in ``store`` with fp32
    weights in [0.25, 2) and scales in [0.5, 1.5): arrivals 1 and 2 tie
    everywhere, arrival 5 ties arrival 0 at every third coordinate;
    ``special`` puts NaN, +inf and -inf at random places and an all -inf
    and an all-NaN coordinate."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((K,) + MLP_PACKED).astype(np.float32)
    if K > 2:
        x[2] = x[1]
    if K > 5:
        x.reshape(K, -1)[5, ::3] = x.reshape(K, -1)[0, ::3]
    if special:
        flat = x.reshape(K, -1)
        for val in (np.nan, np.inf, -np.inf):
            flat[rs.integers(0, K, 256), rs.integers(0, flat.shape[1],
                                                      256)] = val
        flat[:, 11] = -np.inf
        flat[:, 12] = np.nan
    w = torch.tensor(rs.uniform(0.25, 2.0, K), dtype=torch.float32,
                     device=device)
    sc = torch.tensor(rs.uniform(0.5, 1.5, K), dtype=torch.float32,
                      device=device)
    return torch.tensor(x, device=device).to(store), w, sc


def inv_sum(w) -> float:
    """1 / sum(w), the sum taken in ascending order in fp32, as the
    scheduler's apply takes it."""
    total = np.float32(0.0)
    for v in w.cpu().numpy():
        total = np.float32(total + v)
    return float(np.float32(1.0) / total)


def check_agg_kernels(device):
    """The stale accumulate and the robust combine against their plain
    versions on the card, bitwise, at the MLP-128 packing (116, 1024):
    the accumulate at K = 1, 16, 32 over fp32, bf16, e4m3 and e5m2 wires
    with inv_norm 1 and 1/sum(w), and with NaN and inf; the combine at
    K = 15, 16, 32, 65 (past the register buckets) x trim 0, 1, 8 and
    (K-1)//2 x normalize, fp32 with ties, NaN and +-inf and scales !=
    1, at K=16 trim 1 over the narrow wire dtypes, and at K=16 trim 4,
    the main path's setting at S=16."""
    err = {"stale_accum_flat": 0.0, "robust_agg_flat": 0.0}

    def held(label, name, kern, plain):
        before = launch_counts()[name]
        got = kern()
        sync()
        if launch_counts()[name] != before + 1:
            raise SystemExit(f"kernel check {label}: {name} did not launch")
        err[name] = max(err[name], same_bits(label, name, got, plain()))

    n = 0
    for K in (1, 16, 32):
        for store in STORES:
            for special in ((False, True) if store == torch.float32
                            else (False,)):
                x, w, _ = agg_inputs(K, device, SEED + 200 + n, store,
                                     special)
                n += 1
                for inv in (1.0, inv_sum(w)):
                    held(f"stale K={K} {str(store)[6:]}", "stale_accum_flat",
                         lambda: tstale.stale_accum_flat(x, w, inv),
                         lambda: kref.stale_accum_ref(x, w, inv))
                print(f"  stale_accum_flat K={K:2d} {str(store)[6:]:14s}"
                      f"{' NaN/inf' if special else ''} bitwise equal")
    cases = [(K, trim, torch.float32) for K in (15, 16, 32, 65)
             for trim in sorted({0, 1, 8, (K - 1) // 2}) if 2 * trim < K]
    cases += [(16, 1, store) for store in STORES[1:]]
    cases += [(16, 4, torch.float32)]     # robust-comm-int8-randomwire's
    for i, (K, trim, store) in enumerate(cases):
        x, w, sc = agg_inputs(K, device, SEED + 300 + i, store,
                              special=True)
        for normalize in (True, False):
            held(f"robust K={K} trim={trim}", "robust_agg_flat",
                 lambda: trobust.robust_agg_flat(x, w, sc, trim=trim,
                                                 normalize=normalize),
                 lambda: kref.robust_agg_ref(x, w, sc, trim=trim,
                                             normalize=normalize))
        print(f"  robust_agg_flat K={K:2d} trim={trim:2d} "
              f"{str(store)[6:]:14s} NaN/inf/ties, both normalize, "
              "bitwise equal")
    return err


def mlp_trees(device, seed):
    """The MLP-128 params and grads / h_hat / m / h trees of its shapes
    (h and h_hat non-negative)."""
    params = MLPTask(hidden=mlp_mnist.HIDDEN).init(gen(device, seed),
                                                   device)
    g = gen(device, seed + 1)

    def like(scale, positive=False):
        t = {k: scale * torch.randn(v.shape, generator=g, device=device)
             for k, v in params.items()}
        return {k: v.abs() for k, v in t.items()} if positive else t
    return [params, like(0.1), like(0.01, True), like(0.5),
            like(0.02, True)]


def fused_step_plain(trees, do_h, lr):
    """Row 3's plain version: the pack, row 1's plain update, the
    unpack."""
    spec = tflat.flat_spec(trees[0], cols=ops.BLOCK_C)
    outs = sophia_update_ref(*(tflat.pack(t, spec) for t in trees), do_h,
                             lr=lr, **HP)
    return tuple(tflat.unpack(o, spec) for o in outs)


def check_fused_step(device):
    """The pytree route on the MLP-128 trees against its plain version,
    bitwise, for do_h 0 and 1."""
    err = 0.0
    for do_h in (0, 1):
        trees = mlp_trees(device, SEED + 400 + do_h)
        before = ops.LAUNCHES["sophia_fused_step"]
        got = ops.sophia_fused_step(*trees, do_h, lr=LR, **HP)
        sync()
        if ops.LAUNCHES["sophia_fused_step"] != before + 1:
            raise SystemExit("kernel check: sophia_fused_step did not "
                             "launch")
        want = fused_step_plain(trees, do_h, LR)
        for g_, w_ in zip(got, want):
            for k in w_:
                err = max(err, same_bits(f"fused step do_h={do_h} {k}",
                                         "sophia_fused_step", g_[k], w_[k]))
        print(f"  sophia_fused_step MLP-128 pytree do_h={do_h} bitwise "
              "equal")
    return {"sophia_fused_step": err}


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
    # the biased compressors, as the JAX package's comm benchmark runs
    # top-k and SignSGD beside int8
    phases += [
        ("uplink-topk", "parallel",
         dict(compressor="topk", topk_ratio=TOPK_RATIO), R,
         expect(sophia_update_batched=J * R, topk_threshold_batched=R)),
        ("uplink-signsgd-majority", "parallel",
         dict(compressor="signsgd", sign_majority=True), R,
         expect(sophia_update_batched=J * R, sign_roundtrip_batched=R)),
        ("bidir-sign-topk-int4", "parallel", BIASED_BIDIR, R,
         expect(sign_roundtrip_batched=R, topk_threshold_batched=R,
                quant_roundtrip_batched=R, quant_roundtrip_flat=R,
                sophia_update_batched=J * R)),
        ("bidir-sign-topk-int4 sequential", "sequential", BIASED_BIDIR,
         1,
         expect(sign_roundtrip_flat=S, topk_threshold_flat=S,
                quant_roundtrip_flat=S + 1, sophia_update_flat=S * J)),
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
        if label in ("bidir-int8", "bidir-sign-topk-int4"):
            profile_round(engine, state, data, device, steady[label])

    # the virtual-time scheduler (fig_sched's traffic: int8 uplinks, the
    # straggler profile); every dispatch is one batched client step
    int8 = CommConfig(compressor="int8")
    E = SCHED_EVENTS
    chunked = -(-CLIENTS // 8) + (E["chunk8"] - 1) * -(-S // 8)
    sched_phases = [  # (label, SchedConfig, RobustConfig, events, launches)
        ("sched-sync-int8", SchedConfig(discipline="sync", **STRAGGLER),
         RobustConfig(), E["sync"],
         expect(sophia_update_batched=J * E["sync"],
                quant_roundtrip_batched=E["sync"])),
        # one K=16 stale accumulate per event; the cohort of 32 goes out
        # at version 0, 16 clients after every event but the last
        ("sched-semisync-int8",
         SchedConfig(discipline="semisync", buffer_size=S, **STRAGGLER),
         RobustConfig(), E["semisync"],
         expect(sophia_update_batched=J * E["semisync"],
                quant_roundtrip_batched=E["semisync"],
                stale_accum_flat=E["semisync"])),
        # the same in chunks of 8: 4 chunks at version 0, 2 per redispatch
        ("sched-semisync-int8-chunk8",
         SchedConfig(discipline="semisync", buffer_size=S, dispatch_chunk=8,
                     **STRAGGLER),
         RobustConfig(), E["chunk8"],
         expect(sophia_update_batched=J * chunked,
                quant_roundtrip_batched=chunked,
                stale_accum_flat=E["chunk8"])),
        # one N=1 dispatch and one K=1 accumulate per event
        ("sched-async-int8",
         SchedConfig(discipline="async", staleness_power=0.5, **STRAGGLER),
         RobustConfig(), E["async"],
         expect(sophia_update_batched=J * E["async"],
                quant_roundtrip_batched=E["async"],
                stale_accum_flat=E["async"])),
        # the scale attack under norm-clip: one K=16 robust combine (trim
        # 0, scales from the clip) per event
        # (fault seed 1: under seed 0 the byzantine draw is the first six
        # of the straggler draw's permutation, so none would arrive)
        ("sched-semisync-normclip",
         SchedConfig(discipline="semisync", buffer_size=S, **STRAGGLER),
         RobustConfig(aggregator="norm_clip", clip_norm=CLIP_NORM,
                      attack="scale", seed=1, **BYZ), E["normclip"],
         expect(sophia_update_batched=J * E["normclip"],
                quant_roundtrip_batched=E["normclip"],
                robust_agg_flat=E["normclip"])),
    ]
    for label, sched, robust, events, want in sched_phases:
        fed = FedConfig(strategy="parallel", comm=int8, sched=sched,
                        robust=robust, **base)
        secs, losses, state = drive_sched(label, mlp, fed, data, events,
                                          device, want,
                                          attacked=robust.attack != "none")
        record(label, [secs])
        if sched.dispatch_chunk:
            chunk_band(label, mlp, fed, data, events, device, state)
        # the JAX package's loss falls in these phases at this config (its
        # async event losses do not: one client each, non-IID)
        if sched.discipline != "async" and not losses[-1] < losses[0]:
            raise SystemExit(f"{label}: local loss did not fall: {losses}")

    # the adversarial fleet (fig_robust's traffic: 20% byzantine clients
    # on a Dirichlet(0.1) partition, equalized)
    skew = dirichlet_data(device, data)
    RR = ROBUST_ROUNDS
    trimmed = RobustConfig(aggregator="trimmed_mean", trim_fraction=0.25,
                           attack="sign_flip", **BYZ)
    median = RobustConfig(aggregator="coordinate_median", attack="sign_flip",
                          **BYZ)
    robust_phases = [  # (label, strategy, comm, robust, rounds, launches)
        ("robust-direct-trimmed", "parallel", CommConfig(), trimmed, RR,
         expect(sophia_update_batched=J * RR, robust_agg_flat=RR)),
        ("robust-direct-median", "parallel", CommConfig(), median, RR,
         expect(sophia_update_batched=J * RR, robust_agg_flat=RR)),
        ("robust-direct-median sequential", "sequential", CommConfig(),
         median, 1,
         expect(sophia_update_flat=CLIENTS * J, robust_agg_flat=1)),
        ("robust-comm-int8-randomwire", "parallel",
         CommConfig(compressor="int8", participation=0.5),
         RobustConfig(aggregator="trimmed_mean", trim_fraction=0.25,
                      attack="random_wire", **BYZ), RR,
         expect(sophia_update_batched=J * RR, quant_roundtrip_batched=RR,
                robust_agg_flat=RR)),
    ]
    for label, strategy, comm, robust, rounds, want in robust_phases:
        fed = FedConfig(strategy=strategy, comm=comm, robust=robust, **base)
        engine, state, losses, secs = drive(label, mlp, fed, skew, rounds,
                                            device, want)
        record(label, secs)
        trims = {K: robust_trim(robust, K) for K in (CLIENTS, S)}
        print(f"{label}: steady seconds per round {steady[label]}; "
              f"trim per side at K=32 / 16: {trims}")
        # the JAX package's loss falls in each multi-round phase here
        if rounds > 1 and not losses[-1] < losses[0]:
            raise SystemExit(f"{label}: local loss did not fall: {losses}")

    label = "sophia-pytree MLP-128"
    secs = drive_pytree(label, device, data,
                        expect(sophia_fused_step=J, sophia_update_flat=J))
    record(label, [secs])
    return launches, steady


def robust_trim(robust, K):
    return (resolve(robust, K), trim_count(robust, K))


def dirichlet_data(device, data):
    """The main path's images over a Dirichlet(0.1) label partition of
    the 32 clients (`repro_torch.data.partition`), equalized to the
    engine's fixed per-client matrix, as fig_robust builds its skewed
    fleet."""
    x, y, _ = data
    ragged = tpart.dirichlet_label_partition(y.cpu().numpy(), CLIENTS,
                                             DIRICHLET_ALPHA, SEED)
    part = tpart.equalize(ragged, IMAGES // CLIENTS, SEED)
    train_idx, _ = syn.train_test_split(part)
    conc = tpart.label_concentration(tpart.label_marginals(
        y.cpu().numpy(), ragged, 10))
    print(f"Dirichlet({DIRICHLET_ALPHA}) partition: label concentration "
          f"{conc} (IID 0.1), {train_idx.shape[1]} train samples each")
    return x, y, train_idx


def drive_sched(label, task, fed, data, events, device, want,
                attacked=False):
    """One scheduler phase: ``events`` aggregation events of a
    `VirtualScheduler` run (donated state, batches per server version),
    with every launch count set to 0 just before it and read just
    after; an ``attacked`` run must fold byzantine arrivals in.  Returns
    host seconds per event (the run ends in a device synchronise) and
    the event losses."""
    x, y, train_idx = data
    engine = FedEngine(task, fed, device=device)
    state = engine.init(gen(device, SEED + 3))
    sched = VirtualScheduler(
        engine, lambda v: syn.client_batches(gen(device, SEED + 100 + v), x,
                                             y, train_idx, BATCH),
        donate=True)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    state, trace = sched.run(state, events, gen(device, SEED + 1000))
    sync()
    secs = (time.perf_counter() - t0) / events
    got = launch_counts()
    losses = [e.loss for e in trace.events]
    print(f"{label}: event losses {losses}")
    print(f"{label}: virtual seconds {trace.final_time}, wire bytes "
          f"{trace.total_bytes}, staleness histogram "
          f"{trace.staleness_hist()}, clients per event "
          f"{[len(e.clients) for e in trace.events]}, aggregator "
          f"{sorted({e.aggregator for e in trace.events})}, byzantine "
          f"arrivals {sum(len(e.byzantine) for e in trace.events)}")
    print(f"{label}: host seconds per event {secs}")
    print(f"{label}: launches {got}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    if attacked and not any(e.byzantine for e in trace.events):
        raise SystemExit(f"{label}: no byzantine arrival was folded in")
    if len(trace.events) != events or not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: {len(trace.events)} events, losses "
                         f"{losses}")
    params = engine.unpack_params(state)
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise SystemExit(f"{label}: non-finite parameters after the run")
    return secs, losses, state


def chunk_band(label, task, fed, data, events, device, chunked):
    """The chunked run's final state against the same run unchunked, on
    the card (bitwise on the CPU: cuBLAS may choose another algorithm
    for a batch of 8 than for one of 16 or 32, and an int8 floor that
    flips moves a coordinate by a quant step).  Reports the band."""
    x, y, train_idx = data
    plain = dataclasses.replace(fed, sched=dataclasses.replace(
        fed.sched, dispatch_chunk=0))
    engine = FedEngine(task, plain, device=device)
    sched = VirtualScheduler(
        engine, lambda v: syn.client_batches(gen(device, SEED + 100 + v), x,
                                             y, train_idx, BATCH),
        donate=True)
    state, _ = sched.run(engine.init(gen(device, SEED + 3)), events,
                         gen(device, SEED + 1000))
    want, got = state_buffers(state), state_buffers(chunked)
    band = {}
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        band[name] = (int((diff > 0).sum()), float(diff.max()),
                      float((diff / np.maximum(np.abs(w), 1e-30)).max()))
    print(f"{label}: against the unchunked run on the card, (coordinates "
          f"that differ, max |diff|, max relative diff) per buffer: {band}")


def drive_pytree(label, device, data, want):
    """J local steps of the pytree Sophia step (`core.sophia.sophia_step`,
    whose CUDA route is the pack, the kernel, the unpack) on one
    client's MLP-128 params, a GNB refresh every tau steps, with the
    launch counts set to 0 just before and read just after.  Returns
    host seconds per step."""
    x, y, train_idx = data
    task = MLPTask(hidden=mlp_mnist.HIDDEN)
    params = task.init(gen(device, SEED + 3), device)
    state = tsophia.init_state(params)
    batches = syn.client_batches(gen(device, SEED + 100), x, y, train_idx,
                                 BATCH)
    batch = {k: v[0] for k, v in batches.items()}
    noise = gen(device, SEED + 1000)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for j in range(LOCAL_ITERS):
        pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = task.loss(pg, batch)
        grads = dict(zip(pg, torch.autograd.grad(loss, list(pg.values()))))
        do_h = j % TAU == 0
        h_hat = (gnb_estimate(task, pg, batch, gumbel_noise(
            noise, (BATCH, 10), device)) if do_h else
            {k: torch.zeros_like(v) for k, v in params.items()})
        params, state = tsophia.sophia_step(
            {k: v.detach() for k, v in params.items()}, grads, state,
            h_hat, do_h, lr=SOPHIA_LR, **HP)
        losses.append(float(loss.detach()))
    sync()
    secs = (time.perf_counter() - t0) / LOCAL_ITERS
    got = launch_counts()
    print(f"{label}: losses {losses}; host seconds per step {secs}")
    print(f"{label}: launches {got}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    if not all(np.isfinite(losses)) or not all(
            bool(torch.isfinite(v).all()) for v in params.values()):
        raise SystemExit(f"{label}: non-finite loss or parameters")
    return secs


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
    """Records, per stream, the most a flipped coordinate may move its
    reconstruction while active: the largest row scale of a quantizer,
    the largest top-k threshold, twice the largest SignSGD scale (a
    stream whose config view equals another's records into both)."""
    PROBED = ((tcomp.StochasticQuant, "scales", 1.0),
              (tcomp.TopK, "thresholds", 1.0),
              (tcomp.SignSGD, "scales", 2.0))

    def __init__(self, comm):
        self.comm, self.steps = comm, {}

    def __enter__(self):
        self.orig = [getattr(cls, name) for cls, name, _ in self.PROBED]
        for (cls, name, factor), orig in zip(self.PROBED, self.orig):
            setattr(cls, name, self._recording(orig, factor))
        return self

    def _recording(self, orig, factor):
        def wrapped(comp, flat):
            out = orig(comp, flat)
            for name in COMM_STREAMS:
                if comp.cfg == self.comm.stream(name):
                    self.steps[name] = max(self.steps.get(name, 0.0),
                                           factor * float(out.max()))
            return out
        return wrapped

    def __exit__(self, *exc):
        for (cls, name, _), orig in zip(self.PROBED, self.orig):
            setattr(cls, name, orig)


def small_comm_round_check(device):
    """Two small bidir rounds on the card against the same rounds on the
    CPU, int8/int8/int4 with EF on and SignSGD/top-k/int4 with EF auto:
    same weights, batches, GNB noise, participants and quantization
    noise.  Every coordinate of params, m, h, EF residuals and replicas
    within the small band, except at most SMALL_MAX_FLIPS per buffer,
    each within one move of its streams (`ScaleProbe`)."""
    for label, comm_kw, resync in (
            ("bidir int8, EF on", SMALL_COMM, False),
            ("bidir sign/topk/int4, EF auto, resynced", BIASED_BIDIR, True)):
        for strategy in ("parallel", "sequential"):
            small_comm_rounds(device, label, CommConfig(**comm_kw),
                              strategy, resync)


def small_comm_rounds(device, label, comm, strategy, resync):
    """Two small rounds of ``comm`` under ``strategy``, card against
    CPU (`small_comm_round_check`); with ``resync`` each round starts the
    card from a copy of the CPU's state."""
    s = SMALL
    task, x, y, part, init = small_setup()
    fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                    tau=s["tau"], lr=0.02, strategy=strategy, comm=comm)
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
        if resync:
            states[str(device)] = convert.state_from_numpy(
                convert.state_to_numpy(states["cpu"]), device=device)
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
        want = state_buffers(states["cpu"])
        got = state_buffers(states[str(device)])
        counts, bad = {}, []
        for name, w in want.items():
            g = got[name]
            band = SMALL_ATOL + SMALL_RTOL * np.abs(w)
            diff = np.abs(g - w)
            out = diff > band
            step = sum(steps.get(st, 0.0) for st in STEPS_OF[name])
            counts[name] = int(out.sum())
            if counts[name] > SMALL_MAX_FLIPS or not np.all(
                    diff[out] <= step + band[out]):
                bad.append(f"{name} has {counts[name]} coordinates outside "
                           f"the band, largest {float(diff.max())}, step "
                           f"{step}")
        if bad:
            raise SystemExit(f"small comm {label} {strategy} round {r}: "
                             + "; ".join(bad) + f" (all counts {counts})")
        flips.append(counts)
        np.testing.assert_allclose(
            losses[str(device)], losses["cpu"], rtol=SMALL_RTOL,
            atol=SMALL_ATOL,
            err_msg=f"small comm {label} {strategy} round {r}: loss")
    print(f"small comm {strategy} rounds ({label}, S=2 of 4): card "
          f"agrees with the CPU within rtol={SMALL_RTOL} "
          f"atol={SMALL_ATOL} but for coordinates one move off "
          f"(flips per buffer, rounds 1-2): {flips}")


def small_sched_draws(version, ids, rows):
    """Injected randomness of the small scheduler runs, from numpy: per
    dispatch group the gumbel noise ``(N, J, B, 10)`` and the int8
    uplink's U[0, 1) noise ``(N, rows, 1024)``, the same on both
    devices."""
    s = SMALL
    if ids is None:
        return {}
    rs = np.random.default_rng([SEED, 900, version] + list(ids))
    u = rs.uniform(size=(len(ids), s["iters"], s["batch"], 10))
    return {"gumbel": (-np.log(-np.log(np.maximum(u, 1e-30)))).astype(
                np.float32),
            "uplink": rs.uniform(size=(len(ids), rows, 1024)).astype(
                np.float32)}


def small_sched_check(device):
    """A small semisync run (buffer 2, straggler profile) and a small
    async run (lognormal latencies, stale arrivals) on the card against
    the same runs on the CPU, with the same draws: every field of every
    event and dispatch record equal exactly but the losses (within the
    small band), the final state within the small band but for at most
    SMALL_MAX_FLIPS coordinates per buffer, each within one quant step
    (`ScaleProbe`)."""
    s = SMALL
    task, x, y, part, init = small_setup()
    for label, sched, events in (
            ("semisync", SchedConfig(discipline="semisync", buffer_size=2,
                                     **STRAGGLER), 4),
            ("async", SchedConfig(discipline="async",
                                  latency_profile="lognormal", seed=3), 6)):
        fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                        tau=s["tau"], lr=0.02, comm=CommConfig(
                            compressor="int8"), sched=sched)
        out, steps = {}, {}
        for dev in ("cpu", device):
            engine = FedEngine(task, fed, device=dev)
            state = engine.init_from_params({k: v.to(dev)
                                             for k, v in init.items()})
            rows = engine.runtime_for(state["params"]).spec.rows
            batches = {}

            def batch_fn(v, dev=dev):
                if v not in batches:
                    b = syn.client_batches(gen("cpu", 10 + v), x, y, part,
                                           s["batch"])
                    batches[v] = {k: t.to(dev) for k, t in b.items()}
                return batches[v]
            with ScaleProbe(fed.comm) as probe:
                out[str(dev)] = VirtualScheduler(engine, batch_fn).run(
                    state, events, draws=lambda v, ids, rows=rows:
                    small_sched_draws(v, ids, rows))
            for k, v in probe.steps.items():
                steps[k] = max(steps.get(k, 0.0), v)
        (cpu_state, cpu_trace), (card_state, card_trace) = (
            out["cpu"], out[str(device)])
        crec, grec = cpu_trace.to_records(), card_trace.to_records()
        for c, g in zip(crec, grec):
            cl, gl = c.pop("loss", None), g.pop("loss", None)
            if c != g or (cl is not None and not np.isclose(
                    gl, cl, rtol=SMALL_RTOL, atol=SMALL_ATOL)):
                raise SystemExit(f"small {label} run: record {g} (loss "
                                 f"{gl}) differs from the CPU's {c} "
                                 f"(loss {cl})")
        if len(crec) != len(grec):
            raise SystemExit(f"small {label} run: {len(grec)} records, CPU "
                             f"{len(crec)}")
        want, got = state_buffers(cpu_state), state_buffers(card_state)
        counts = {}
        for name, w in want.items():
            band = SMALL_ATOL + SMALL_RTOL * np.abs(w)
            diff = np.abs(got[name] - w)
            bad = diff > band
            counts[name] = int(bad.sum())
            step = sum(steps.get(st, 0.0) for st in STEPS_OF[name])
            if counts[name] > SMALL_MAX_FLIPS or not np.all(
                    diff[bad] <= step + band[bad]):
                raise SystemExit(f"small {label} run: {name} has "
                                 f"{counts[name]} coordinates outside the "
                                 f"band, largest {float(diff.max())}")
        print(f"small {label} run ({events} events, staleness "
              f"{card_trace.staleness_hist()}): records equal the CPU's, "
              f"state within rtol={SMALL_RTOL} atol={SMALL_ATOL} but for "
              f"coordinates one quant step off: {counts}")


def small_robust_check(device):
    """Two small direct rounds with a 25% sign-flip fleet under a
    trimmed mean (C=4: trim 1), parallel and sequential, on the card
    against the CPU: same weights, batches and GNB noise; within the
    small band."""
    s = SMALL
    task, x, y, part, init = small_setup()
    robust = RobustConfig(aggregator="trimmed_mean", trim_fraction=0.25,
                          attack="sign_flip", attack_fraction=0.25)
    for strategy in ("parallel", "sequential"):
        fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                        tau=s["tau"], lr=0.02, strategy=strategy,
                        robust=robust)
        out = {}
        for dev in ("cpu", device):
            engine = FedEngine(task, fed, device=dev)
            state = engine.init_from_params(
                {k: v.to(dev) for k, v in init.items()})
            losses = []
            for r in range(s["rounds"]):
                b = syn.client_batches(gen("cpu", 10 + r), x, y, part,
                                       s["batch"])
                state, metrics = engine.round(
                    state, {k: v.to(dev) for k, v in b.items()},
                    gumbel=torch.tensor(small_noise(r, s), device=dev))
                losses.append(float(metrics["loss"]))
            out[str(dev)] = (losses, engine.pack_state(state)["params"].cpu(),
                             state["client_opt"].m.cpu())
        for what, a, b in zip(("loss", "params", "m"), out[str(device)],
                              out["cpu"]):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=SMALL_RTOL,
                atol=SMALL_ATOL,
                err_msg=f"small robust {strategy} round: {what}")
        print(f"small robust {strategy} rounds (sign-flip 1 of 4, trimmed "
              f"mean): card agrees with the CPU within rtol={SMALL_RTOL} "
              f"atol={SMALL_ATOL}")


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


def time_blocking_ms(fn, calls=TIMED_CHUNK):
    """Device milliseconds per call of ``fn``, for a call that may block
    the host: events bracket each call alone, each from an idle device.
    Also whether it blocks: one call queued behind the sleep kernel
    returns only after the sleep when it waits for the device."""
    fn(0)
    sync()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    fn(0)
    waited_ms = (time.perf_counter() - t0) * 1e3
    sync()
    total = 0.0
    for i in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        stop.record()
        sync()
        total += start.elapsed_time(stop)
    return total / calls, waited_ms


def bound(ins, outs_like, ops_per_coord):
    """Least time for one call: the larger of bytes over HBM rate and
    fp32 operations over the rate of fp32 instructions that are not
    FMAs.  Each input read once, each output written once (a shared
    operand counts once)."""
    nbytes = sum(x.numel() * x.element_size() for x in ins)
    nbytes += sum(x.numel() * x.element_size() for x in outs_like)
    ops = ops_per_coord * outs_like[0].numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_pair(name, kern, plain, ins, outs_like, ops_per_coord,
              plain_chunk=TIMED_CHUNK, kernel_chunk=TIMED_CHUNK):
    """Device ms of kernel and plain version in turns (plain, kernel,
    kernel, plain), host ms per kernel call, and the bound.  A plain
    version of many launches is queued ``plain_chunk`` calls at a time
    (a kernel entry of costly host work ``kernel_chunk``), so that each
    chunk's enqueue stays within the sleep and within the launch queue
    (past about a thousand pending launches the host blocks behind the
    sleep)."""
    p1, k1, k2, p2 = (time_ms(plain, chunk=plain_chunk),
                      time_ms(kern, chunk=kernel_chunk),
                      time_ms(kern, chunk=kernel_chunk),
                      time_ms(plain, chunk=plain_chunk))
    host = host_ms(kern)
    b_ms, b_by, nbytes = bound(ins, outs_like, ops_per_coord)
    ops_ms = ops_per_coord * outs_like[0].numel() / FP32_OPS_PER_S * 1e3
    k = (k1 + k2) / 2
    shape = list(outs_like[0].shape)
    print(f"{name} {tuple(shape)} fp32: device kernel {k1} / {k2} ms, "
          f"plain {p1} / {p2} ms, bound {b_ms} ms ({b_by}, {nbytes} "
          f"bytes; operations {ops_ms} ms); kernel at {nbytes / k / 1e9} TB/s, {b_ms / k} of the "
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
    del th, sv, ef, u, s, st
    out.update(time_biased(device))
    out.update(time_slice4(device))
    return out


def timing_stacks(K, device, seed, l2_bytes=50 * 2 ** 20):
    """Copies of a fp32 ``(K, 116, 1024)`` stack, enough of them to
    exceed the 50 MB L2 together, so that launches that walk them in turn
    read from device memory; fp32 weights and scales as `agg_inputs`."""
    g = gen(device, seed)
    one = K * MLP_PACKED[0] * MLP_PACKED[1] * 4
    xs = [torch.randn((K,) + MLP_PACKED, generator=g, device=device)
          for _ in range(l2_bytes // one + 2)]
    w = 0.25 + 1.75 * torch.rand(K, generator=g, device=device)
    sc = 0.5 + torch.rand(K, generator=g, device=device)
    return xs, w, sc


def time_slice4(device):
    """Rows 3, 14 and 15 and their plain versions at the main path's
    shapes, fp32: the stale accumulate at K=16 (semisync's buffer; the
    row's headline) and K=1 (async), beside ``torch.tensordot(w, wires,
    dims=1) * inv_norm``, the one library call of the same function (not
    bitwise: cuBLAS's GEMV sums in its own order); the robust combine at
    K=32 trim 8 (the trimmed mean of the direct phase; the headline),
    K=32 trim 15 (the median), K=16 trim 4 (the comm round's trimmed
    mean at S=16) and K=16 trim 0 with clip scales (norm-clip), beside
    ``torch.sort(wires, dim=0)``, the sort the kernel avoids (no library
    call computes the combine); the pytree step on the MLP-128 trees."""
    out = {}
    R, C = MLP_PACKED
    agg_out = [torch.empty((R, C), device=device)]
    for K in (16, 1):
        xs, w, _ = timing_stacks(K, device, SEED + 500 + K)
        # a one-element device tensor: the plain version would otherwise
        # copy a host float to the card, which waits for the stream
        inv = torch.tensor([inv_sum(w)], device=device)
        n = len(xs)
        t = time_pair(f"stale_accum_flat (K={K})",
                      lambda i: tstale.stale_accum_flat(xs[i % n], w, inv),
                      lambda i: kref.stale_accum_ref(xs[i % n], w, inv),
                      [xs[0], w], agg_out, stale_ops(K), plain_chunk=10)
        t["library_ms"] = time_ms(
            lambda i: torch.tensordot(w, xs[i % n], dims=1) * inv)
        print(f"stale_accum_flat (K={K}): torch.tensordot(w, wires, "
              f"dims=1) * inv_norm {t['library_ms']} ms (not bitwise)")
        out.setdefault("stale_accum_flat", t)
        del xs
    for K, trim, clip in ((32, 8, False), (32, 15, False), (16, 4, False),
                          (16, 0, True)):
        xs, w, sc = timing_stacks(K, device, SEED + 600 + K + trim)
        if not clip:
            sc = torch.ones_like(sc)
        n = len(xs)
        t = time_pair(f"robust_agg_flat (K={K}, trim={trim}"
                      f"{', clip scales' if clip else ''})",
                      lambda i: trobust.robust_agg_flat(xs[i % n], w, sc,
                                                        trim=trim),
                      lambda i: kref.robust_agg_ref(xs[i % n], w, sc,
                                                    trim=trim),
                      [xs[0], w, sc], agg_out, robust_ops(K, trim),
                      plain_chunk=2)
        sort_ms = time_ms(lambda i: torch.sort(xs[i % n], dim=0))
        t["library_ms"] = None
        print(f"robust_agg_flat (K={K}, trim={trim}): torch.sort(wires, "
              f"dim=0), the sort it avoids, {sort_ms} ms")
        out.setdefault("robust_agg_flat", t)
        del xs
    # 24 sets of the five MLP-128 trees (57 MB) walked in turn
    sets = [mlp_trees(device, SEED + 700 + k) for k in range(24)]
    lr = torch.tensor(LR)
    leaves = [v for tree in sets[0] for v in tree.values()]
    n = sum(v.numel() for v in sets[0][0].values())
    flat_like = [torch.empty(n, device=device)] * 3
    out["sophia_fused_step"] = time_pair(
        "sophia_fused_step (MLP-128 pytree)",
        lambda i: ops.sophia_fused_step(*sets[i % 24], 1, lr=lr, **HP),
        lambda i: fused_step_plain(sets[i % 24], 1, lr), leaves, flat_like,
        SOPHIA_OPS, plain_chunk=5, kernel_chunk=10)
    return out


def time_biased(device):
    """The sign and threshold kernels and their plain versions at the
    main path's shapes (32 clients; 16 for the bidir phase), and the
    library reductions that compute their per-client scalars outside
    them: `TopK.thresholds` (``torch.topk``) and `SignSGD.scales`
    (``torch.sum``), as ``scalar_ms`` (`time_blocking_ms`: a call that
    waits for the device cannot be queued behind the sleep)."""
    N, R, C = (CLIENTS,) + MLP_PACKED
    x, v = biased_inputs((N, R, C), device, SEED + 97)
    h = N // 2
    spec = tflat.flat_spec(MLPTask(hidden=mlp_mnist.HIDDEN).init(
        gen(device, SEED), device), cols=C)
    topk = tcomp.TopK(CommConfig(compressor="topk", topk_ratio=TOPK_RATIO),
                      spec)
    signs = tcomp.SignSGD(CommConfig(compressor="signsgd"), spec)
    print(f"top-k keeps k = {topk.k} of {spec.total} coordinates "
          f"(ratio {TOPK_RATIO}, accounting "
          f"{tacc.topk_k(topk.cfg, spec.total)})")
    out = {}
    for name, kern, plain, ops, scalar in (
            ("sign_roundtrip", tq.sign_roundtrip_batched,
             kref.sign_roundtrip_ref, BIASED_OPS["sign"], signs.scales),
            ("topk_threshold", tq.topk_threshold_batched,
             kref.topk_threshold_ref, BIASED_OPS["topk"], topk.thresholds)):
        for n in (N, h):
            xs, vs = x[:n], v[:n]
            key = f"{name}_batched" + ("" if n == N else f" (S={n})")
            t = time_pair(key, lambda i: kern(xs, vs),
                          lambda i: plain(xs, vs), [xs, vs], [xs], ops)
            t["scalar_ms"], waited = time_blocking_ms(lambda i: scalar(xs))
            print(f"{key}: its scalars by {scalar.__qualname__} "
                  f"{t['scalar_ms']} ms per call; one call behind a "
                  f"{SLEEP_CYCLES}-cycle sleep returned after {waited} ms")
            if n == N:
                out[f"{name}_batched"] = t
        flat = getattr(tq, f"{name}_flat")
        t = time_pair(f"{name}_flat", lambda i: flat(x[i % N], v[i % N]),
                      lambda i: plain(x[i % N], v[i % N]), [x[0], v[0]],
                      [x[0]], ops)
        t["scalar_ms"], waited = time_blocking_ms(
            lambda i: scalar(x[i % N]))
        print(f"{name}_flat: its scalar by {scalar.__qualname__} "
              f"{t['scalar_ms']} ms per call; one call behind the sleep "
              f"returned after {waited} ms")
        out[f"{name}_flat"] = t
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:8]:
        print(f"  {t:10.1f} us  {n:5d}x  {name[:90]}")
    # the compressors' kernels and top-k's selection, wherever they rank
    comm = [(rank, name, t, n) for rank, (name, (t, n)) in enumerate(ranked)
            if any(w in name.lower() for w in COMM_KERNEL_WORDS)]
    for rank, name, t, n in comm:
        print(f"  comm stage, rank {rank + 1}: {t:10.1f} us  {n:5d}x  "
              f"{name[:80]}")


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
    err.update(check_biased_kernels(device))
    err.update(check_agg_kernels(device))
    err.update(check_fused_step(device))

    small_round_check(device)
    small_comm_round_check(device)
    small_sched_check(device)
    small_robust_check(device)
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
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "host_ms": t["host_ms"], "scalar_ms": t.get("scalar_ms"),
            "shape": t["shape"], "bitwise_vs_plain": True})
    print("library_ms: torch.tensordot(w, wires, dims=1) * inv_norm for "
          "stale_accum_flat (not bitwise); none elsewhere: no single "
          "PyTorch call computes the Sophia update or a stochastic-rounding "
          "quantize round-trip (fake_quantize_per_channel_affine rounds to "
          "nearest, without noise), nor SignSGD's round-trip (torch.sign "
          "gives 0 for NaN and +0 for -0), top-k's threshold (a compare "
          "and a select) or the trimmed / clipped combine (torch.sort "
          "sorts, it does not trim or weight)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
