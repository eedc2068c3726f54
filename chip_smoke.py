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
Sophia step (one launch of the kernel a step; one profiled call must
show that kernel alone), and the engine's other settings (FedAdam and
FedYogi; DONE, parallel and sequential; micro-batched gradients; bf16
and fp8 resident state on the direct, int8 and bidir paths, with the
JAX package's resident-byte gates and each launch's kernel form
asserted; the health probes, whose states must equal their unprobed
twins' bit for bit; FedAdam behind the semisync apply on bf16 state);
checks small rounds, scheduler runs and each new setting against the
same on the CPU, sweeps the grids of the Sophia, quantize, uplink,
broadcast, sign / threshold and stale-accumulate kernels' fp32 forms,
and times each kernel with CUDA events (the 16-client batched ones also
on copies past the L2).  Every path runs with the launch counts set to 0
just before it and read just after; the EF uplink, bidir and biased comm
paths must also have taken the fp32 form of the uplink, broadcast, sign
and threshold kernels at every launch of those.
It then trains a federated LM through the trainer's CLI
(`repro_torch.launch.train.main`): minicpm-2b at its published widths
(d_model 2304, 36 heads of 64, d_ff 5760, vocab 122,880 padded), the
depth cut to 2 layers, 4 clients, J=2, tau=2, batch 2, seq 256, for 3
rounds with a record log and a checkpoint, then resumes from it for 1
(`lm_train`: exact launch counts, valid records carrying the schema
fingerprint, a valid chrome trace, the checkpoint restored bitwise and
its save and restore timed, one profiled round); the same path with an
int8 uplink (`lm_comm`), and gemma2-9b at its published widths (d_model
3584, 16 heads of 256, 8 kv heads, d_ff 14336, vocab 256,000; one local
and one global block with both softcaps and post-norms) on the
sequential strategy with an int8 uplink, 2 clients (`lm_seq`), and
deepseek-v2-lite-16b at its published widths (d_model 2048, 16 heads
of MLA attention with a 512-wide latent, 64 routed experts of d_ff 1408
top-6 and 2 shared, vocab 102,400 untied) the same way (`lm_moe`: its
peak reckoned by buffer first, the MoE dispatch / combine share of the
profiled round, the routers fp32 through the checkpoint, the resumed
round's loss below round 0's on the same batches); the recurrent
mixers at their published widths on their arch's parallel strategy with
an int8 uplink, 2 clients: recurrentgemma-2b cut to 3 layers (two RG-LRU
blocks with their causal conv and a local attention block; `lm_rec`)
and xlstm-1.3b cut to 8 layers (seven mLSTM blocks and an sLSTM block,
no FFN; `lm_xlstm`), each with its peak reckoned by buffer first
(`reckon_par_peak`; every LM phase's peak is gated against its
reckoning), each scan's share of the profiled round and the resumed
round's loss below round 0's; holds the reduced LMs' rounds on the card
against the CPU (`lm_small_check`: minicpm-2b, gemma2-9b, qwen3-14b,
deepseek-v2-lite-16b and qwen3-moe-235b-a22b on their strategies,
deepseek also parallel, with the MoE routing compared choice by choice;
minicpm-2b at bidir int8/int8/int4, int8 with EF, top-k and SignSGD with
the majority vote; recurrentgemma-2b at 3 and 5 layers, xlstm-1.3b with
and without its FFN; since slice 14 qwen2-vl-2b and hubert-xlarge on
embeds) and checks and times the leaf-boundary form (row 2b) and rows 4
and 5 at the LM slices' shapes (`time_lm_kernels`, the ``lm_kernels``
line).  Slice 14 trains the
embedding-input archs at their published widths, parallel, int8:
hubert-xlarge, a bidirectional encoder, at its full 48 layers, 2 clients
(`lm_enc`), and qwen2-vl-2b with M-RoPE cut to 2 layers, 4 clients
(`lm_vlm`); holds every serving cache kind on the card against the CPU
(`serve_small_check`: reduced, fp32, teacher-forced; logits and caches
leaf by leaf), and serves through the serve CLI's twin
(`repro_torch.launch.serve.main`) at the full published depth, bf16:
qwen2-vl-2b x 28 layers, batch 8, prompt 512, gen 64 on patch
embeddings, and gemma2-9b x 42 layers, batch 2, prompt 4352 (past its
4096 window), gen 32 (`lm_serve`: the peak reckoned by buffer first,
the decode logits against the full forward's, prefill seconds, decode
p50 / p95 ms, tokens/s, a profiled decode step; no kernel of the table
runs there).
Slice 15 holds the cost tools to the card (`dry_check`): one round of
`lm_train`, `lm_seq`, `lm_moe`, `lm_rec` and `lm_vlm` traced shape-only
(`repro_torch.launch.dryrun.trace`, every kernel entry on its shape-only
path) must launch exactly what the phase counted and peak within 10% of
what it measured (printed beside the reckoning, with the roofline time
over the profiled round's device time); the five dry runs of the JAX
package's small dry-run test, at the published widths with the deep
ones' depth cut, end ``ok``; and it runs the three
example twins (`examples_check`: fed_llm_train at its defaults,
comm_compression, serve_batched for chatglm3-6b and xlstm-1.3b), each
run's launches equal to a trace of the same rounds.
Slice 16: every LM phase trains with per-block remat (the config
default; the peaks reckoned on the remat graph) and prints its steady
seconds, busy share and peak beside the card; `examples_check` also
runs one cell of Table I's twin (hyperparam_table), one row-2 launch a
local step; `lm_small_check` first holds remat's loss grads and GNB
estimate on the card bitwise to those without it (`remat_check`:
minicpm-2b and deepseek-v2-lite-16b, reduced, fp32 and bf16).  Each
phase prints its wall seconds (``phase wall seconds:``).
Any failure ends the run with a nonzero exit; nothing is caught.
Without a card it exits nonzero before printing any result.

The narrow forms of rows 2, 5 and 9 that the resident dtype policy runs are
timed beside the sixteen and printed as a ``{"narrow_kernels": [...]}``
line.  The second-to-last line of standard output is the ``{"kernels":
[...]}`` record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
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
                                      FedConfig, ObsConfig, RobustConfig,
                                      SchedConfig)
from repro_torch.core import sophia as tsophia  # noqa: E402
from repro_torch.core.fed import FedEngine  # noqa: E402
from repro_torch.core.gnb import gnb_estimate  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import robust_agg as trobust  # noqa: E402
from repro_torch.kernels import sophia_update as tk  # noqa: E402
from repro_torch.kernels import stale_accum as tstale  # noqa: E402
from repro_torch.kernels.ref import sophia_update_ref  # noqa: E402
from repro_torch.models.layers import ROUTE_SPAN  # noqa: E402
from repro_torch.models.recurrent import (  # noqa: E402
    MLSTM_CHUNK, MLSTM_SPAN, RGLRU_SPAN, SLSTM_SPAN)
from repro_torch.models.small import (CNNTask, MLPTask,  # noqa: E402
                                      gumbel_noise)
from repro_torch.obs.probes import PROBE_METRICS  # noqa: E402
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
#: fp32 operations per coordinate of each kernel (`kernels/cost.py`)
SOPHIA_OPS, QUANT_OPS, BIASED_OPS = (kcost.SOPHIA_OPS, kcost.QUANT_OPS,
                                     kcost.BIASED_OPS)
stale_ops, robust_ops = kcost.stale_ops, kcost.robust_ops
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
STEPS_OF = {"params": ("uplink", "downlink", "clip"),
            "m": ("uplink", "downlink"),
            "h": ("uplink", "downlink", "hessian"),
            "comm_ef": ("uplink",), "comm_dn_model": ("downlink",),
            "comm_dn_ef": ("downlink",)}

#: the JAX package's Pallas kernels each CUDA entry point replaces
REPLACES = {
    "sophia_update_batched": "src/repro/kernels/sophia_update.py:100",
    "sophia_update_flat": "src/repro/kernels/sophia_update.py:57",
    # the round engine's step at the loss/grad boundary: row 2 (row 1
    # for one client) with the pack and unpack around it
    "sophia_update_leaves": "src/repro/kernels/sophia_update.py:100",
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


def at_offset(x, offset: int):
    """A contiguous view of ``x``'s values that starts ``offset``
    elements into its storage (offset 1: not 16-byte aligned)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def check_kernels(device):
    """Each kernel against its plain version on the card, bitwise
    (compared as raw bytes, NaN included).  Returns the largest
    |kernel - plain| over finite coordinates, per kernel.  The Sophia
    cases cover both forms of the kernel: the fp32 form (fp32, aligned;
    n % 4 != 0 and in place included) and the runtime-dtype form (any
    narrow operand, or inputs at storage offset 1), then every dtype
    combination of the five operands but all-fp32."""
    bf16 = (torch.bfloat16,) * 3
    fp8 = (torch.float32, torch.float8_e4m3fn, torch.float8_e5m2)
    N, R, C = (CLIENTS,) + MLP_PACKED
    cases = [  # (label, entry, shape, dtypes, do_h, special, in place,
               #  storage offset)
        ("batched fp32 do_h=0", "batched", (N, R, C), None, 0, False, False,
         0),
        ("batched fp32 do_h=1", "batched", (N, R, C), None, 1, False, False,
         0),
        ("batched fp32 in place", "batched", (N, R, C), None, 1, False, True,
         0),
        ("batched bf16 theta/m/h", "batched", (N, R, C), bf16, 1, False,
         False, 0),
        ("batched bf16 do_h=0", "batched", (N, R, C), bf16, 0, False, False,
         0),
        ("batched e4m3 m + e5m2 h", "batched", (N, R, C), fp8, 1, False,
         False, 0),
        ("batched NaN/inf", "batched", (N, R, C), None, 1, True, False, 0),
        ("batched fp8 NaN/inf", "batched", (N, R, C), fp8, 1, True, False,
         0),
        ("flat fp32", "flat", (R, C), None, 1, False, False, 0),
        ("flat fp32 in place", "flat", (R, C), None, 0, False, True, 0),
        ("batched ragged", "batched", (3, 7, 1000), None, 1, False, False,
         0),
        ("flat ragged e4m3 m + e5m2 h", "flat", (7, 1000), fp8, 1, False,
         False, 0),
        ("flat fp32 offset 1", "flat", (R, C), None, 1, True, False, 1),
        ("batched fp32 offset 1", "batched", (N, R, C), None, 1, False,
         False, 1),
        ("flat fp32 offset 1 in place", "flat", (R, C), None, 0, False,
         True, 1),
        ("flat fp32 n%4=1", "flat", (7, 999), None, 1, True, False, 0),
        ("batched fp32 n%4=3", "batched", (3, 7, 999), None, 1, False, False,
         0),
        ("flat fp32 n%4=1 in place", "flat", (7, 999), None, 0, False, True,
         0),
        ("batched fp32 n%4=3 in place", "batched", (3, 7, 999), None, 1,
         True, True, 0),
        ("flat fp32 n=3", "flat", (1, 3), None, 1, False, False, 0),
    ]
    fns = {"batched": tk.sophia_update_batched, "flat": tk.sophia_update_flat}
    err = {"sophia_update_batched": 0.0, "sophia_update_flat": 0.0}

    def held(label, entry, ins, do_h, inplace, want_f32x4):
        want = sophia_update_ref(*ins, do_h, lr=LR, **HP)
        key = f"sophia_update_{entry}"
        before = tk.LAUNCHES[key]
        args = ([at_offset(x, x.storage_offset()) for x in ins[:3]]
                + ins[3:] if inplace else ins)
        outs = args[:3] if inplace else [torch.empty_like(x)
                                         for x in ins[:3]]
        if tk.takes_f32x4(*outs, *args) != want_f32x4:
            form = "fp32" if want_f32x4 else "runtime-dtype"
            raise SystemExit(f"kernel check {label}: the wrapper would not "
                             f"take the {form} form")
        got = fns[entry](*args, do_h, LR, inplace=inplace, **HP)
        sync()
        if tk.LAUNCHES[key] != before + 1:
            raise SystemExit(f"kernel check {label}: the kernel did not "
                             "launch")
        err[key] = max(err[key], same_bits(label, key, got, want))

    for i, (label, entry, shape, dts, do_h, special, inplace,
            offset) in enumerate(cases):
        ins = sophia_inputs(shape, device, SEED + i,
                            dts or (torch.float32,) * 3, special)
        ins = [at_offset(x, offset) for x in ins]
        f32x4 = dts is None and offset == 0
        held(label, entry, ins, do_h, inplace, f32x4)
        print(f"  {label:30s} {tuple(shape)} "
              f"{'fp32' if f32x4 else 'runtime-dtype'} form, bitwise equal")
    # every dtype of each of the five operands but all five fp32: the
    # runtime-dtype form, at a ragged shape, NaN/inf and fp8 overflow in
    base = [x.float() for x in sophia_inputs((7, 999), device, SEED + 50,
                                             fp8, special=True)]
    combos = [c for c in itertools.product(STORES, repeat=5)
              if any(dt != torch.float32 for dt in c)]
    for j, combo in enumerate(combos):
        ins = [x.to(dt) for x, dt in zip(base, combo)]
        held(f"sophia dtypes {combo}", ("flat", "batched")[j % 2],
             ins if j % 2 == 0 else [x.unsqueeze(0) for x in ins], j % 3 % 2,
             j % 5 == 0, False)
    print(f"  every dtype combination but all-fp32 ({len(combos)}, flat and "
          "batched in turn, 1 in 5 in place) runtime-dtype form, bitwise "
          "equal")
    err["sophia_update_leaves"] = check_leaf_boundary(device)
    return err


def leaf_inputs(device, seed, tree, lead, swap=()):
    """The leaf-boundary form's operands over the parameter dict
    ``tree`` (its keys, shapes and dtypes) for ``lead`` clients: the
    spec, fp32 theta, m, h (zero past the leaves, every 17th h 0), the
    grads and h_hat leaves (``swap``'s keys stored with their last two
    axes swapped) and the zero h_hat buffer."""
    rs = np.random.default_rng(seed)
    spec = tflat.flat_spec(tree, cols=1024)

    def leaves(scale, positive, swapped):
        out = {}
        for k, v in tree.items():
            x = scale * rs.standard_normal(lead + tuple(v.shape))
            x = torch.tensor(np.abs(x) if positive else x,
                             dtype=torch.float32, device=device).to(v.dtype)
            if k in swapped:
                x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
            out[k] = x
        return out
    state = []
    for scale in (1.0, 0.1, 0.01):
        x = scale * rs.standard_normal(lead + (spec.padded,))
        x[..., spec.total:] = 0.0
        state.append(torch.tensor(x.reshape(lead + (spec.rows, spec.cols)),
                                  dtype=torch.float32, device=device))
    state[2] = state[2].abs()
    state[2].reshape(-1)[::17] = 0.0
    return (spec, *state, leaves(0.5, False, swap),
            leaves(0.02, True, swap), torch.zeros_like(state[0]))


def check_leaf_boundary(device) -> float:
    """The leaf-boundary form (the round engine's step at the loss/grad
    boundary) against its plain version, bitwise: MLP-128's fp32 leaves
    for the cohort and one client (no params store: they are views of
    theta), and an LM-like bf16 tree with a tied embedding's swapped
    grad, a plain step and a refresh, with and without the store."""
    mlp = MLPTask(hidden=mlp_mnist.HIDDEN).init(gen(device, SEED), device)
    bf = torch.bfloat16
    lm = {"blocks_0/w": torch.empty(2, 96, 2304, dtype=bf),
          "embed": torch.empty(1000, 2304, dtype=bf),
          "final_norm": torch.empty(2304, dtype=bf)}
    worst = 0.0
    cases = [("MLP-128 cohort", mlp, (CLIENTS,), (), (0, 1), False),
             ("MLP-128 one client", mlp, (), (), (1,), False),
             ("LM-like bf16 cohort", lm, (4,), ("embed",), (0, 1), True),
             ("LM-like bf16 one client", lm, (), ("embed",), (1,), True)]
    for i, (label, tree, lead, swap, do_hs, stored) in enumerate(cases):
        spec, th, m, h, g, hh, zero = leaf_inputs(device, SEED + 60 + i,
                                                  tree, lead, swap)
        for do_h in do_hs:
            for store in ((True, False) if stored else (False,)):
                h_hat = hh if do_h else zero
                out = ({k: torch.full(lead + tuple(v.shape), float("nan"),
                                      dtype=v.dtype, device=device)
                        for k, v in tree.items()} if store else None)
                want = kref.sophia_update_leaves_ref(
                    th, m, h, g, h_hat, float(do_h), spec=spec,
                    out_dtypes={k: v.dtype for k, v in (out or {}).items()},
                    lr=LR, **HP)
                got = [x.clone() for x in (th, m, h)]
                before = tk.STEPS["sophia_update_leaves"]
                tk.sophia_update_leaves(*got, g, h_hat, do_h, LR, spec=spec,
                                        out=out, **HP)
                sync()
                if tk.STEPS["sophia_update_leaves"] != before + 1:
                    raise SystemExit(f"kernel check {label}: the leaf-"
                                     "boundary form did not launch")
                name = f"{label} do_h={do_h} store={store}"
                worst = max(worst, same_bits(name, "sophia_update_leaves",
                                             tuple(got), want[:3]))
                for k in (out or {}):
                    same_bits(f"{name} {k}", "sophia_update_leaves", out[k],
                              want[3][k])
                print(f"  leaf boundary {name:44s} bitwise equal")
    return worst


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


#: the quant entries' two forms on fp32: (label, shape, x offset, noise
#: offset, qmax, NaN/inf, fp32 form); a 3D shape goes to the batched entry
QUANT_FORMS = [
    ("flat quant MLP-128 int8", MLP_PACKED, 0, 0, 127, False, True),
    ("flat quant MLP-128 int4 NaN/inf", MLP_PACKED, 0, 0, 7, True, True),
    ("flat quant x offset 1", MLP_PACKED, 1, 0, 127, True, False),
    ("flat quant noise offset 1", (7, 1000), 0, 1, 7, False, False),
    ("flat quant C % 4 = 2", (7, 1002), 0, 0, 127, True, False),
    ("flat quant C % 4 = 3", (5, 3), 0, 0, 7, False, False),
    ("batched quant x16 int4 NaN/inf", (CLIENTS // 2,) + MLP_PACKED, 0, 0,
     7, True, True),
    ("batched quant x offset 1", (3, 7, 1000), 1, 0, 127, True, False),
    ("batched quant C % 4 = 2", (3, 7, 1002), 0, 0, 7, True, False),
]


#: the uplink entries' two forms: (label, shape, shared start, theta
#: dtype, ef dtype, theta offset, noise offset, fp32 form); a 3D shape
#: goes to the batched entry
F32, BF16, E4M3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
UPLINK_FORMS = [
    ("flat uplink MLP-128", MLP_PACKED, False, F32, F32, 0, 0, True),
    ("flat uplink ragged", (7, 1000), False, F32, F32, 0, 0, True),
    ("batched uplink x32 shared start", (CLIENTS,) + MLP_PACKED, True, F32,
     F32, 0, 0, True),
    ("batched uplink stacked start", (3, 7, 1000), False, F32, F32, 0, 0,
     True),
    ("flat uplink bf16 theta", (7, 1000), False, BF16, F32, 0, 0, False),
    ("flat uplink e4m3 ef", (7, 1000), False, F32, E4M3, 0, 0, False),
    ("flat uplink theta offset 1", MLP_PACKED, False, F32, F32, 1, 0, False),
    ("flat uplink noise offset 1", (7, 1000), False, F32, F32, 0, 1, False),
    ("flat uplink C % 4 = 2", (7, 1002), False, F32, F32, 0, 0, False),
    ("batched uplink C % 4 = 2", (3, 7, 1002), True, F32, F32, 0, 0, False),
]


def launch_form(label, name, f32x4, takes, call):
    """``call()`` on the card: the wrapper's form rule (``takes``, its
    answer for these inputs) and the launch must both pick entry
    ``name``'s fp32 form if ``f32x4`` and its runtime-dtype form if not;
    one launch.  Returns the call's result."""
    form = "fp32" if f32x4 else "runtime"
    if takes != f32x4:
        raise SystemExit(f"kernel check {label}: the wrapper would not take "
                         f"the {form} form")
    before = (tq.LAUNCHES[name], tq.F32X4_LAUNCHES[name])
    got = call()
    sync()
    if (tq.LAUNCHES[name], tq.F32X4_LAUNCHES[name]) != (
            before[0] + 1, before[1] + int(f32x4)):
        raise SystemExit(f"kernel check {label}: {name} did not launch its "
                         f"{form} form")
    return got


def check_uplink_forms(device):
    """Both forms of the uplink entries (`UPLINK_FORMS`), bitwise the
    plain version, with NaN and +-inf in theta, a NaN and an inf scale,
    zero rows (scale 0) and clipped codes; one launch a call, counted as
    the form the table says."""
    err = 0.0
    for i, (label, shape, shared, tdt, edt, to, uo, f32x4) in enumerate(
            UPLINK_FORMS):
        name = ("uplink_roundtrip_batched" if len(shape) == 3
                else "uplink_roundtrip_flat")
        theta, start, ef, u, s = quant_inputs(shape, device, SEED + 120 + i,
                                              shared=shared, special=True)
        theta.reshape(-1)[::97] = float("inf")
        theta.reshape(-1)[1::89] = -float("inf")
        theta, ef, u = at_offset(theta.to(tdt), to), ef.to(edt), \
            at_offset(u, uo)
        outs = [torch.empty(theta.shape, dtype=tdt, device=device)] * 2
        got = launch_form(label, name, f32x4,
                          tq.uplink_takes_f32x4(outs, theta, start, ef, u),
                          lambda: getattr(tq, name)(theta, start, ef, u, s,
                                                    qmax=127))
        err = max(err, same_bits(label, name, got, kref.uplink_roundtrip_ref(
            theta, start, ef, u, s, qmax=127)))
        print(f"  {label:32s} {shape} "
              f"{'fp32' if f32x4 else 'runtime-dtype'} form, bitwise equal")
    return err


#: the broadcast entries' two forms: (label, shape, shared theta, theta
#: (server model) dtype, ref (replica) dtype, ef dtype, operand at storage
#: offset 1 or None, fp32 form); a 3D shape goes to the batched entry
#: (the flat entry's theta is the one (R, C) model)
BROADCAST_FORMS = [
    ("flat broadcast MLP-128", MLP_PACKED, True, F32, F32, F32, None, True),
    ("flat broadcast ragged", (7, 1000), True, F32, F32, F32, None, True),
    ("batched broadcast x16 shared theta", (CLIENTS // 2,) + MLP_PACKED,
     True, F32, F32, F32, None, True),
    ("batched broadcast stacked theta", (3, 7, 1000), False, F32, F32, F32,
     None, True),
    ("flat broadcast bf16 theta", (7, 1000), True, BF16, F32, F32, None,
     False),
    ("flat broadcast bf16 ref", (7, 1000), True, F32, BF16, F32, None,
     False),
    ("flat broadcast e4m3 ef", (7, 1000), True, F32, F32, E4M3, None, False),
    ("flat broadcast theta offset 1", (7, 1000), True, F32, F32, F32,
     "theta", False),
    ("flat broadcast ref offset 1", MLP_PACKED, True, F32, F32, F32, "ref",
     False),
    ("flat broadcast noise offset 1", (7, 1000), True, F32, F32, F32,
     "noise", False),
    ("flat broadcast C % 4 = 2", (7, 1002), True, F32, F32, F32, None,
     False),
    ("batched broadcast ef offset 1", (3, 7, 1000), True, F32, F32, F32,
     "ef", False),
    ("batched broadcast C % 4 = 3", (3, 7, 999), False, F32, F32, F32, None,
     False),
]


def check_broadcast_forms(device):
    """Both forms of the broadcast entries (`BROADCAST_FORMS`), bitwise
    the plain version, with NaN and +-inf in the replicas and +-inf in
    the server model, a NaN and an inf scale, zero rows (scale 0) and
    clipped codes; one launch a call, counted as the form the table
    says."""
    err = 0.0
    for i, (label, shape, shared, tdt, rdt, edt, off, f32x4) in enumerate(
            BROADCAST_FORMS):
        name = ("broadcast_roundtrip_batched" if len(shape) == 3
                else "broadcast_roundtrip_flat")
        ref, theta, ef, u, s = quant_inputs(shape, device, SEED + 150 + i,
                                            shared=shared or len(shape) == 2,
                                            special=True)
        theta.reshape(-1)[::97] = float("inf")
        theta.reshape(-1)[1::89] = -float("inf")
        ins = {"theta": kref.store_as(theta, tdt),
               "ref": kref.store_as(ref, rdt), "ef": kref.store_as(ef, edt),
               "noise": u}
        theta, ref, ef, u = (at_offset(t, int(k == off))
                             for k, t in ins.items())
        outs = [torch.empty(shape, dtype=tdt, device=device)] * 2
        got = launch_form(label, name, f32x4,
                          tq.broadcast_takes_f32x4(outs, theta, ref, ef, u),
                          lambda: getattr(tq, name)(theta, ref, ef, u, s,
                                                    qmax=127))
        err = max(err, same_bits(label, name, got,
                                 kref.broadcast_roundtrip_ref(
                                     theta, ref, ef, u, s, qmax=127)))
        print(f"  {label:36s} {shape} "
              f"{'fp32' if f32x4 else 'runtime-dtype'} form, bitwise equal")
    return err


def check_quant_kernels(device):
    """Each quantize entry point against its plain version on the card,
    bitwise: at the main path's shapes; at a ragged (3, 7, 1000) with
    fp32, bf16, e4m3 and e5m2 state, the shared operand shared and
    stacked; with NaN and inf; zero rows and clipped codes in every
    case; the shared operand against its materialised stack; both forms
    of the quant entries on fp32 (`QUANT_FORMS`), of the uplink entries
    (`UPLINK_FORMS`) and of the broadcast entries (`BROADCAST_FORMS`)."""
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
    for i, (label, shape, xo, uo, qmax, special, f32x4) in enumerate(
            QUANT_FORMS):
        name = ("quant_roundtrip_batched" if len(shape) == 3
                else "quant_roundtrip_flat")
        x, _, _, u, s = quant_inputs(shape, device, SEED + 80 + i,
                                     special=special, qmax=qmax)
        if special:
            x.reshape(-1)[:: 97] = float("inf")
            x.reshape(-1)[1:: 89] = -float("inf")
        x, u = at_offset(x, xo), at_offset(u, uo)
        if tq.quant_takes_f32x4(torch.empty_like(x), x, u) != f32x4:
            raise SystemExit(f"kernel check {label}: the wrapper would not "
                             f"take the {'fp32' if f32x4 else 'runtime'} "
                             "form")
        before = tq.LAUNCHES[name]
        got = getattr(tq, name)(x, u, s, qmax=qmax)
        sync()
        if tq.LAUNCHES[name] != before + 1:
            raise SystemExit(f"kernel check {label}: {name} did not launch")
        err[name] = max(err[name], same_bits(
            label, name, got, kref.quant_roundtrip_ref(x, u, s, qmax=qmax)))
        print(f"  {label:30s} {shape} "
              f"{'fp32' if f32x4 else 'runtime-dtype'} form, bitwise equal")
    up = check_uplink_forms(device)
    for name in ("uplink_roundtrip_flat", "uplink_roundtrip_batched"):
        err[name] = max(err[name], up)
    down = check_broadcast_forms(device)
    for name in ("broadcast_roundtrip_flat", "broadcast_roundtrip_batched"):
        err[name] = max(err[name], down)
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
    +-0 and +-inf, and a ragged (3, 7, 999) at fp32; ties at every
    client's threshold and one client with scalar 0 in each case; then
    both forms (`BIASED_FORMS`)."""
    N, (R, C) = CLIENTS, MLP_PACKED
    cases = [("MLP-128 x 32 fp32", (N, R, C), torch.float32, False),
             ("MLP-128 x 16 fp32 NaN/inf", (N // 2, R, C), torch.float32,
              True)]
    for store in STORES:
        for special in (False, True):
            cases.append((f"ragged {str(store)[6:]}"
                          + (" NaN/0/inf" if special else ""),
                          (3, 7, 1000), store, special))
    cases.append(("ragged fp32 per client % 4 = 1", (3, 7, 999),
                  torch.float32, True))
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
    forms = check_biased_forms(device)
    for name in err:
        err[name] = max(err[name], forms)
    return err


#: the sign / threshold entries' two forms: (label, stack shape, x dtype,
#: x storage offset, fp32 form); "flat" labels call the flat entries on
#: client 1 of the stack, "batched" labels the batched ones on the whole
BIASED_FORMS = [
    ("flat biased MLP-128", (2,) + MLP_PACKED, F32, 0, True),
    ("flat biased C % 4 = 3, per client % 4 = 0", (2, 4, 999), F32, 0,
     True),
    ("flat biased offset 4", (2, 7, 1000), F32, 4, True),
    ("flat biased offset 1", (2,) + MLP_PACKED, F32, 1, False),
    ("flat biased per client % 4 = 1", (2, 7, 999), F32, 0, False),
    ("flat biased bf16", (2, 7, 1000), BF16, 0, False),
    ("batched biased x32", (CLIENTS,) + MLP_PACKED, F32, 0, True),
    ("batched biased x16", (CLIENTS // 2,) + MLP_PACKED, F32, 0, True),
    ("batched biased C % 4 = 3, per client % 4 = 0", (3, 4, 999), F32, 0,
     True),
    ("batched biased offset 1", (3, 7, 1000), F32, 1, False),
    ("batched biased ragged", (3, 7, 999), F32, 0, False),
    ("batched biased e4m3", (3, 7, 1000), E4M3, 0, False),
]


def check_biased_forms(device):
    """Both forms of the sign and threshold entries (`BIASED_FORMS`),
    bitwise the plain versions, with NaN, +-0, +-inf and ties at each
    client's scalar (one client's scalar 0); one launch a call, counted as
    the form the table says.  Returns the largest |difference| over
    finite values."""
    err = 0.0
    for i, (label, shape, store, off, f32x4) in enumerate(BIASED_FORMS):
        x, v = biased_inputs(shape, device, SEED + 170 + i, store,
                             special=True)
        kind = label.split()[0]
        if kind == "flat":
            x, v = x[1], v[1]
        x = at_offset(x, off)
        takes = tq.biased_takes_f32x4(torch.empty_like(x), x)
        for fn, plain in (("sign_roundtrip", kref.sign_roundtrip_ref),
                          ("topk_threshold", kref.topk_threshold_ref)):
            name = f"{fn}_{kind}"
            got = launch_form(label, name, f32x4, takes,
                              lambda: getattr(tq, name)(x, v))
            err = max(err, same_bits(label, name, got, plain(x, v)))
        print(f"  {label:44s} {tuple(x.shape)} "
              f"{'fp32' if f32x4 else 'runtime-dtype'} form, bitwise equal")
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


#: what each kind of robust-combine check stack holds
AGG_KINDS = {"special": "NaN/inf/ties", "finite": "finite, ties",
             "mixed": "NaN/inf at every 3rd coordinate",
             "edges": "+-FLT_MAX/+-0 ties"}


def agg_inputs(K, device, seed, store=torch.float32, special=False,
               mixed=False):
    """A ``(K, 116, 1024)`` arrival stack stored in ``store`` with fp32
    weights in [0.25, 2) and scales in [0.5, 1.5): arrivals 1 and 2 tie
    everywhere, arrival 5 ties arrival 0 at every third coordinate;
    ``special`` puts NaN, +inf and -inf at random places and an all -inf
    and an all-NaN coordinate; ``mixed`` also one NaN, +inf or -inf at
    every third coordinate, so that every warp mixes the kernel's two
    forms."""
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
    if mixed:
        flat = x.reshape(K, -1)
        cols = np.arange(0, flat.shape[1], 3)
        flat[rs.integers(0, K, cols.size), cols] = rs.choice(
            np.array([np.nan, np.inf, -np.inf], np.float32), cols.size)
    w = torch.tensor(rs.uniform(0.25, 2.0, K), dtype=torch.float32,
                     device=device)
    sc = torch.tensor(rs.uniform(0.5, 1.5, K), dtype=torch.float32,
                      device=device)
    return torch.tensor(x, device=device).to(store), w, sc


def agg_edge_inputs(K, device, seed):
    """A fp32 ``(K, 116, 1024)`` stack of heavy ties drawn from {-FLT_MAX,
    -1, -0, +0, 1, FLT_MAX} (only +-1 and +-0 at even coordinates, which
    the kernel's sort form takes; the odd ones, +-FLT_MAX among them, its
    pass form), every 16th coordinate all equal; fp32 weights in [0.25,
    2) and unit scales, so that +-FLT_MAX stays finite."""
    rs = np.random.default_rng(seed)
    big = np.finfo(np.float32).max
    alphabet = np.array([-big, -1.0, -0.0, 0.0, 1.0, big], np.float32)
    flat = alphabet[rs.integers(0, 6, (K, MLP_PACKED[0] * MLP_PACKED[1]))]
    flat[:, ::2] = alphabet[rs.integers(1, 5, flat[:, ::2].shape)]
    flat[:, ::16] = flat[0, ::16]
    w = torch.tensor(rs.uniform(0.25, 2.0, K), dtype=torch.float32,
                     device=device)
    x = torch.tensor(flat.reshape((K,) + MLP_PACKED), device=device)
    return x, w, torch.ones(K, device=device)


def sort_form_share(x, sc):
    """The share of coordinates whose K scaled values all have magnitude
    below FLT_MAX: those the robust combine's sort form takes."""
    xs = sc.reshape((-1,) + (1,) * (x.ndim - 1)) * x.float()
    return (xs.abs() < torch.finfo(torch.float32).max).all(0).float().mean()


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
    the accumulate at K = 1, 2, 9, 16, 17, 32, 33 (the kernel's batches
    of sixteen loads and their tails) over fp32, bf16, e4m3 and e5m2
    wires with inv_norm 1 and 1/sum(w), with NaN and inf, and fp32 wires
    at an element offset of 1 (the one-coordinate form); the combine at
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
    for K in (1, 2, 9, 16, 17, 32, 33):
        for store, offset in [(st, 0) for st in STORES] + [(F32, 1)]:
            for special in ((False, True) if store == torch.float32
                            else (False,)):
                x, w, _ = agg_inputs(K, device, SEED + 200 + n, store,
                                     special)
                x = at_offset(x, offset)
                n += 1
                f32x4 = store == torch.float32 and offset == 0
                if tstale.takes_f32x4(torch.empty(MLP_PACKED, device=device),
                                      x) != f32x4:
                    raise SystemExit(f"kernel check stale K={K}: the wrapper "
                                     "would not take the expected form")
                for inv in (1.0, inv_sum(w)):
                    held(f"stale K={K} {str(store)[6:]}", "stale_accum_flat",
                         lambda: tstale.stale_accum_flat(x, w, inv),
                         lambda: kref.stale_accum_ref(x, w, inv))
                print(f"  stale_accum_flat K={K:2d} {str(store)[6:]:14s}"
                      f"{' offset 1' if offset else ''}"
                      f"{' NaN/inf' if special else ''} "
                      f"{'fp32' if f32x4 else 'one-coordinate'} form, "
                      "bitwise equal")
    cases = [(K, trim, torch.float32, "special") for K in (15, 16, 32, 65)
             for trim in sorted({0, 1, 8, (K - 1) // 2}) if 2 * trim < K]
    cases += [(16, 1, store, "special") for store in STORES[1:]]
    cases += [(16, 4, torch.float32, "special")]  # the comm round's, S=16
    # the sort form (every value finite) in each register bucket and the
    # any-K form; +-FLT_MAX and +-0 ties; warps that mix both forms
    cases += [(K, trim, torch.float32, "finite") for K in (5, 16, 17, 32, 33,
                                                          64, 65, 100)
              for trim in sorted({1, K // 4, (K - 1) // 2}) if 2 * trim < K]
    cases += [(16, 4, torch.bfloat16, "finite"), (32, 8, torch.float8_e4m3fn,
                                                  "finite")]
    cases += [(K, trim, torch.float32, kind) for kind in ("edges", "mixed")
              for K in (16, 32, 64, 65)
              for trim in sorted({1, K // 4, (K - 1) // 2})]
    for i, (K, trim, store, kind) in enumerate(cases):
        if kind == "edges":
            x, w, sc = agg_edge_inputs(K, device, SEED + 300 + i)
        else:
            x, w, sc = agg_inputs(K, device, SEED + 300 + i, store,
                                  special=kind != "finite",
                                  mixed=kind == "mixed")
        for normalize in (True, False):
            held(f"robust K={K} trim={trim} {kind}", "robust_agg_flat",
                 lambda: trobust.robust_agg_flat(x, w, sc, trim=trim,
                                                 normalize=normalize),
                 lambda: kref.robust_agg_ref(x, w, sc, trim=trim,
                                             normalize=normalize))
        form = ("any-K form" if K > 64 else
                f"sort form at {float(sort_form_share(x, sc)):.4f}")
        print(f"  robust_agg_flat K={K:3d} trim={trim:2d} "
              f"{str(store)[6:]:14s} {AGG_KINDS[kind]}, {form} of "
              "coordinates, both normalize, bitwise equal")
    return err


def mlp_trees(device, seed):
    """The MLP-128 params and grads / h_hat / m / h trees of its shapes
    (h and h_hat non-negative)."""
    params = MLPTask(hidden=mlp_mnist.HIDDEN).init(gen(device, seed),
                                                   device)
    return trees_like(params, seed + 1)


def fused_step_plain(trees, do_h, lr):
    """Row 3's plain version: the pack, row 1's plain update, the
    unpack."""
    spec = tflat.flat_spec(trees[0], cols=ops.BLOCK_C)
    outs = sophia_update_ref(*(tflat.pack(t, spec) for t in trees), do_h,
                             lr=lr, **HP)
    return tuple(tflat.unpack(o, spec) for o in outs)


def trees_like(params, seed, overflow=False):
    """The five trees of a step on ``params``: m and h in each params
    leaf's dtype (as `init_state` makes them), g and h_hat fp32 (h and
    h_hat non-negative); ``overflow`` scales g and h_hat past the fp8
    ranges."""
    g = gen(params[next(iter(params))].device, seed)

    def like(scale, positive=False, keep=False):
        out = {}
        for k, v in params.items():
            t = scale * torch.randn(v.shape, generator=g, device=v.device)
            t = t.abs() if positive else t
            out[k] = t.to(v.dtype) if keep else t
        return out
    big = 1e4 if overflow else 1.0
    return [params, like(0.1, keep=True), like(0.01, True, keep=True),
            like(0.5 * big), like(0.02 * big * big, True)]


def fused_step_cases(device):
    """(label, trees, launches, do_h values) of the pytree step's checks:
    the MLP-128 and CNN trees; leaves that take each form of the kernel
    in one launch (fp32 aligned with n % 4 != 0, offset-1 views, one
    params leaf per dtype with fp8 overflow, m narrower than params, NaN
    and inf); more leaves than the cap (one launch per
    `ops.MAX_LEAVES`)."""
    cases = [(f"MLP-128 pytree do_h={d}", mlp_trees(device, SEED + 400 + d),
              1, (d,)) for d in (0, 1)]
    cnn = CNNTask(channels=cnn_mnist.CHANNELS).init(gen(device, SEED + 402),
                                                     device)
    cases.append(("CNN pytree", trees_like(cnn, SEED + 403), 1, (0, 1)))
    rs = np.random.default_rng(SEED + 404)
    shapes = {"a": (64, 32), "b": (1,), "c": (3,), "d": (10,),
              "e": (7, 143), "f": (33, 64), "g": (40, 40), "h": (31,),
              "i": (2, 257), "j": (1000,)}
    params = {k: torch.tensor(rs.standard_normal(sh), dtype=torch.float32,
                              device=device) for k, sh in shapes.items()}
    params["f"] = at_offset(params["f"], 1)
    for k, dt in zip("ghi", STORES[1:]):
        params[k] = params[k].to(dt)
    trees = trees_like(params, SEED + 405, overflow=True)
    trees[1]["j"] = trees[1]["j"].to(torch.bfloat16)
    trees[3]["a"] = at_offset(trees[3]["a"], 1)
    trees[2]["e"][0, :3] = float("nan")
    trees[3]["d"][:2] = float("inf")
    cases.append(("ragged, offset 1, every dtype, NaN/inf", trees, 1,
                  (0, 1)))
    for leaves in (33, 98):
        params = {f"p{i:03d}": torch.tensor(
            rs.standard_normal(1 + (i * 389) % 2000), dtype=torch.float32,
            device=device) for i in range(leaves)}
        cases.append((f"{leaves} leaves", trees_like(params, SEED + leaves),
                      -(-leaves // ops.MAX_LEAVES), (1,)))
    return cases


def check_fused_step(device):
    """The pytree route against its plain version, bitwise, for do_h 0
    and 1 (`fused_step_cases`): its launches as many as the cap gives,
    none of the flat Sophia entry, each output leaf in its params leaf's
    dtype."""
    err = 0.0
    for label, trees, launches, do_hs in fused_step_cases(device):
        for do_h in do_hs:
            ops.reset_launches()
            tk.reset_launches()
            got = ops.sophia_fused_step(*trees, do_h, lr=LR, **HP)
            sync()
            if (ops.LAUNCHES["sophia_fused_step"] != launches
                    or any(tk.LAUNCHES.values())):
                raise SystemExit(f"kernel check {label}: launches "
                                 f"{ops.LAUNCHES} {tk.LAUNCHES}, want "
                                 f"{launches} of sophia_fused_step only")
            want = fused_step_plain(trees, do_h, LR)
            for g_, w_ in zip(got, want):
                for k in w_:
                    err = max(err, same_bits(f"fused step {label} {k}",
                                             "sophia_fused_step", g_[k],
                                             w_[k]))
        print(f"  sophia_fused_step {label:40s} {launches} launch(es), "
              "bitwise equal")
    profile_fused_step(device)
    return {"sophia_fused_step": err}


def profile_fused_step(device):
    """One pytree step on the MLP-128 trees under `torch.profiler`: its
    device activities must be the one launch of the kernel, with no
    pack's `cat` or `pad` and no unpack's copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trees = mlp_trees(device, SEED + 410)
    ops.sophia_fused_step(*trees, 1, lr=LR, **HP)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.sophia_fused_step(*trees, 1, lr=LR, **HP)
        sync()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    print(f"  sophia_fused_step profiled: device activities {names}")
    if len(names) != 1 or "sophia_leaves_kernel" not in names[0]:
        raise SystemExit("profile: the pytree step ran other device work "
                         f"than its one kernel: {names}")


# --------------------------------------------------------------- main path
def make_data(device):
    x, y = syn.make_image_data(gen(device, SEED), IMAGES, "mnist", noise=1.3)
    part = syn.dirichlet_partition(SEED + 1, y, CLIENTS, alpha=0.5)
    train_idx, _ = syn.train_test_split(part)
    return x, y, train_idx


def run_rounds(task, fed, data, rounds, device, packed=False):
    """``rounds`` rounds through `FedEngine.round` (from packed-resident
    state with ``packed``); returns the final state, the per-round
    losses and host seconds per round (each timed around work that ends
    in a device synchronise)."""
    x, y, train_idx = data
    engine = FedEngine(task, fed, device=device)
    state = engine.init(gen(device, SEED + 3))
    if packed:
        state = engine.pack_state(state)
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


def drive(label, task, fed, data, rounds, device, want, packed=False):
    """One path of the main run, with every launch count set to 0 just
    before it and read just after.  ``want``: the exact launch count of
    each kernel on this path."""
    reset_launches()
    engine, state, losses, secs = run_rounds(task, fed, data, rounds,
                                             device, packed)
    got = launch_counts()
    print(f"{label}: losses {losses}")
    print(f"{label}: seconds per round {secs}")
    print(f"{label}: launches {got}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    return engine, state, losses, secs


def main_path(device):
    """The main path's runs; returns each kernel's launch count summed
    over the paths (each read just after its own path), the steady
    seconds per round of each path, and the Sophia launches of each
    phase of `settings_phases`."""
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
        expect(sophia_update_leaves=MLP_ROUNDS * LOCAL_ITERS))
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
                          expect(sophia_update_leaves=CLIENTS * LOCAL_ITERS))
    record(label, secs)

    cnn = CNNTask(channels=cnn_mnist.CHANNELS)
    label = "fed_sophia parallel CNN-(16,32)"
    engine, state, _, secs = drive(
        label, cnn, sophia, data, CNN_ROUNDS, device,
        expect(sophia_update_leaves=CNN_ROUNDS * LOCAL_ITERS))
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
         expect(sophia_update_leaves=J * R, quant_roundtrip_batched=R)),
        ("uplink-int8-ef", "parallel",
         dict(compressor="int8", error_feedback=True), R,
         expect(sophia_update_leaves=J * R, uplink_roundtrip_batched=R)),
        ("bidir-int8", "parallel", bidir, R,
         expect(broadcast_roundtrip_batched=R, sophia_update_leaves=J * R,
                quant_roundtrip_batched=2 * R, quant_roundtrip_flat=R)),
        ("bidir-int8-ef sequential", "sequential",
         dict(bidir, error_feedback=True), 1,
         expect(broadcast_roundtrip_flat=S, sophia_update_leaves=S * J,
                uplink_roundtrip_flat=S, quant_roundtrip_flat=S + 1)),
    ]
    # the biased compressors, as the JAX package's comm benchmark runs
    # top-k and SignSGD beside int8
    phases += [
        ("uplink-topk", "parallel",
         dict(compressor="topk", topk_ratio=TOPK_RATIO), R,
         expect(sophia_update_leaves=J * R, topk_threshold_batched=R)),
        ("uplink-signsgd-majority", "parallel",
         dict(compressor="signsgd", sign_majority=True), R,
         expect(sophia_update_leaves=J * R, sign_roundtrip_batched=R)),
        ("bidir-sign-topk-int4", "parallel", BIASED_BIDIR, R,
         expect(sign_roundtrip_batched=R, topk_threshold_batched=R,
                quant_roundtrip_batched=R, quant_roundtrip_flat=R,
                sophia_update_leaves=J * R)),
        ("bidir-sign-topk-int4 sequential", "sequential", BIASED_BIDIR,
         1,
         expect(sign_roundtrip_flat=S, topk_threshold_flat=S,
                quant_roundtrip_flat=S + 1, sophia_update_leaves=S * J)),
    ]
    # launches of the uplink, broadcast, sign and threshold kernels' fp32
    # forms: every one of them
    f32x4_want = {
        "uplink-int8-ef": dict(uplink_roundtrip_batched=R),
        "bidir-int8": dict(broadcast_roundtrip_batched=R),
        "bidir-int8-ef sequential": dict(uplink_roundtrip_flat=S,
                                         broadcast_roundtrip_flat=S),
        "uplink-topk": dict(topk_threshold_batched=R),
        "uplink-signsgd-majority": dict(sign_roundtrip_batched=R),
        "bidir-sign-topk-int4": dict(sign_roundtrip_batched=R,
                                     topk_threshold_batched=R),
        "bidir-sign-topk-int4 sequential": dict(sign_roundtrip_flat=S,
                                                topk_threshold_flat=S)}
    for label, strategy, comm_kw, rounds, want in phases:
        fed = FedConfig(strategy=strategy, comm=CommConfig(**comm_kw),
                        **base)
        engine, state, losses, secs = drive(label, mlp, fed, data, rounds,
                                            device, want)
        record(label, secs)
        check_forms(label, f32x4_want.get(label, {}))
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
         expect(sophia_update_leaves=J * E["sync"],
                quant_roundtrip_batched=E["sync"])),
        # one K=16 stale accumulate per event; the cohort of 32 goes out
        # at version 0, 16 clients after every event but the last
        ("sched-semisync-int8",
         SchedConfig(discipline="semisync", buffer_size=S, **STRAGGLER),
         RobustConfig(), E["semisync"],
         expect(sophia_update_leaves=J * E["semisync"],
                quant_roundtrip_batched=E["semisync"],
                stale_accum_flat=E["semisync"])),
        # the same in chunks of 8: 4 chunks at version 0, 2 per redispatch
        ("sched-semisync-int8-chunk8",
         SchedConfig(discipline="semisync", buffer_size=S, dispatch_chunk=8,
                     **STRAGGLER),
         RobustConfig(), E["chunk8"],
         expect(sophia_update_leaves=J * chunked,
                quant_roundtrip_batched=chunked,
                stale_accum_flat=E["chunk8"])),
        # one N=1 dispatch and one K=1 accumulate per event
        ("sched-async-int8",
         SchedConfig(discipline="async", staleness_power=0.5, **STRAGGLER),
         RobustConfig(), E["async"],
         expect(sophia_update_leaves=J * E["async"],
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
         expect(sophia_update_leaves=J * E["normclip"],
                quant_roundtrip_batched=E["normclip"],
                robust_agg_flat=E["normclip"])),
    ]
    for label, sched, robust, events, want in sched_phases:
        fed = FedConfig(strategy="parallel", comm=int8, sched=sched,
                        robust=robust, **base)
        secs, losses, state, _ = drive_sched(label, mlp, fed, data, events,
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
         expect(sophia_update_leaves=J * RR, robust_agg_flat=RR)),
        ("robust-direct-median", "parallel", CommConfig(), median, RR,
         expect(sophia_update_leaves=J * RR, robust_agg_flat=RR)),
        ("robust-direct-median sequential", "sequential", CommConfig(),
         median, 1,
         expect(sophia_update_leaves=CLIENTS * J, robust_agg_flat=1)),
        ("robust-comm-int8-randomwire", "parallel",
         CommConfig(compressor="int8", participation=0.5),
         RobustConfig(aggregator="trimmed_mean", trim_fraction=0.25,
                      attack="random_wire", **BYZ), RR,
         expect(sophia_update_leaves=J * RR, quant_roundtrip_batched=RR,
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
    secs = drive_pytree(label, device, data, expect(sophia_fused_step=J))
    record(label, [secs])
    narrow = settings_phases(device, data, mlp, base, record)
    return launches, steady, narrow


# ------------------------------------------- the engine's settings (slice 9)
BF16_STATE = dict(state_dtype="bfloat16")
#: the JAX package's fp8 regime (benchmarks/run.py, packed-donated-fp8-
#: pallas): bf16 params, e4m3 moments, e5m2 hessian EMA
FP8_STATE = dict(state_dtype="bfloat16", moment_dtype="float8_e4m3fn",
                 hessian_dtype="float8_e5m2")
#: the JAX package's resident-byte gates against the fp32 twin
#: (benchmarks/run.py: bf16 <= 0.55x, the fp8 regime <= 0.30x)
RESIDENT_GATES = {"bf16-packed": 0.55, "fp8-int8-packed": 0.30}
#: DONE as the JAX package's Fig. 2 runs it (benchmarks/run.py,
#: benchmarks/common.py: J=1, lr 1.0; 20 Richardson steps, damping 10)
DONE = dict(optimizer="done", local_iters=1, lr=1.0,
            done_richardson_iters=20, done_damping=10.0)
#: phases whose local loss falls in the JAX package at the same config
#: (MLP-128 x 32 clients, batch 64, 60,000 synthetic images; the JAX
#: engine on the CPU, `use_pallas` off)
LOSS_FALLS = ("fedadam", "fedyogi", "done", "microbatch2", "bf16-packed",
              "fp8-int8-packed", "bidir-int8-bf16", "probes",
              "sched-semisync-int8 probes", "sched-semisync-fedadam-bf16")


def state_tensors(state) -> dict:
    """name -> tensor of every resident buffer of an engine state."""
    out = {}

    def walk(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(f"{name}.{k}", x[k])
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k in x._fields:
                walk(f"{name}.{k}", getattr(x, k))
    for k in sorted(state):
        walk(k, state[k])
    return out


def resident_bytes(state) -> int:
    """The state's resident bytes, exact: every tensor's nbytes."""
    return sum(t.numel() * t.element_size()
               for t in state_tensors(state).values())


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def same_state_bits(label, a, b) -> None:
    ta, tb = state_tensors(a), state_tensors(b)
    if sorted(ta) != sorted(tb):
        raise SystemExit(f"{label}: buffers {sorted(ta)} vs {sorted(tb)}")
    for k in ta:
        if ta[k].dtype != tb[k].dtype or not torch.equal(bits(ta[k]),
                                                         bits(tb[k])):
            raise SystemExit(f"{label}: {k} differs from the unprobed "
                             "run's")
    print(f"{label}: state bitwise the unprobed run's ({len(ta)} buffers)")


def narrow_band_check(label, got, want, rtol=SMALL_RTOL, atol=SMALL_ATOL):
    """Every buffer within the band of `kernels.ref.band_breach`: fp32
    within rtol/atol; a narrow one within that or its
    `kernels.ref.NARROW_STEPS` steps of its dtype, a few coordinates out
    to the outlier steps.  Returns each narrow buffer's largest steps
    apart outside rtol/atol."""
    tg, tw = state_tensors(got), state_tensors(want)
    if sorted(tg) != sorted(tw):
        raise SystemExit(f"{label}: buffers {sorted(tg)} vs {sorted(tw)}")
    worst = {}
    for k in tw:
        if tg[k].dtype != tw[k].dtype:
            raise SystemExit(f"{label}: {k} is {tg[k].dtype} on the card, "
                             f"{tw[k].dtype} on the CPU")
        x, y = tg[k].cpu(), tw[k].cpu()
        breach = kref.band_breach(x, y, rtol=rtol, atol=atol)
        if breach:
            raise SystemExit(f"{label}: {k} on the card against the CPU: "
                             f"{breach}")
        if y.dtype in kref.NARROW_STEPS:
            off = ~((x.float() - y.float()).abs()
                    <= atol + rtol * y.float().abs())
            worst[k] = int((kref.dtype_steps(x, y) * off).max())
    return worst


#: small card-vs-CPU runs of the new settings: (FedConfig kwargs, packed)
SMALL_SETTINGS = {
    "fedadam": (dict(optimizer="fedadam"), False),
    "fedyogi sequential packed": (dict(optimizer="fedyogi",
                                       strategy="sequential"), True),
    "done": (DONE, False),
    "done sequential": (dict(DONE, strategy="sequential"), False),
    "microbatch2": (dict(grad_microbatches=2), False),
    "microbatch4 round": (dict(grad_microbatches=4,
                               hessian_every_unit="round"), False),
    "bf16 packed": (dict(comm=CommConfig(**BF16_STATE)), True),
    "fp8 packed sequential": (dict(comm=CommConfig(**FP8_STATE),
                                   strategy="sequential"), True),
    "fedadam bf16 packed": (dict(optimizer="fedadam",
                                 comm=CommConfig(**BF16_STATE)), True),
    "probes": (dict(obs=ObsConfig(probes=True)), False),
}


def small_settings_check(device):
    """Two small rounds of each new setting on the card against the same
    rounds on the CPU: same initial weights, batches and GNB noise;
    the round metrics (losses, probes) within rtol/atol, the state
    within `narrow_band_check`'s band."""
    s = SMALL
    task, x, y, part, init = small_setup()
    for label, (kw, packed) in SMALL_SETTINGS.items():
        cfg = dict(num_clients=s["clients"], local_iters=s["iters"],
                   tau=s["tau"], lr=0.02)
        cfg.update(kw)
        fed = FedConfig(**cfg)
        draws = 1 if fed.hessian_every_unit == "round" else fed.local_iters
        out = {}
        for dev in ("cpu", device):
            engine = FedEngine(task, fed, device=dev)
            state = engine.init_from_params(
                {k: v.to(dev) for k, v in init.items()})
            if packed:
                state = engine.pack_state(state)
            scalars = []
            for r in range(s["rounds"]):
                b = syn.client_batches(gen("cpu", 10 + r), x, y, part,
                                       s["batch"])
                noise = torch.tensor(small_noise(r, s)[:, :draws],
                                     device=dev)
                state, metrics = engine.round(
                    state, {k: v.to(dev) for k, v in b.items()},
                    gumbel=noise)
                scalars.append([float(metrics[k]) for k in
                                ("loss",) + (PROBE_METRICS if
                                             fed.obs.probes else ())])
            out[str(dev)] = (np.asarray(scalars), state)
        (cs, cstate), (gs, gstate) = out["cpu"], out[str(device)]
        np.testing.assert_allclose(gs, cs, rtol=SMALL_RTOL, atol=SMALL_ATOL,
                                   err_msg=f"small {label}: round metrics")
        worst = narrow_band_check(f"small {label}", gstate, cstate)
        print(f"small {label}: card agrees with the CPU (losses card "
              f"{gs[:, 0].tolist()} cpu {cs[:, 0].tolist()}); narrow "
              f"buffers' largest steps apart outside rtol/atol {worst}")


def settings_phases(device, data, mlp, base, record):
    """The engine's settings of slice 9 at full width: FedAdam / FedYogi,
    DONE (parallel and sequential), micro-batched gradients, bf16 and
    fp8 resident state (direct, int8 uplink, bidir), the health probes
    (direct and semisync) and a bf16 FedAdam semisync run.  Each phase
    runs with the launch counts set to 0 just before it and read just
    after; the narrow phases also assert each launch's form."""
    J, R = LOCAL_ITERS, COMM_ROUNDS
    S = CLIENTS // 2
    int8 = dict(compressor="int8")
    bidir = dict(compressor="int8", downlink_compressor="int8",
                 hessian_compressor="int4", participation=0.5)
    phases = [  # (label, FedConfig kwargs, rounds, packed, launches, forms)
        ("fedadam", dict(base, optimizer="fedadam"), R, False, expect(), {}),
        ("fedyogi", dict(base, optimizer="fedyogi"), R, False, expect(), {}),
        ("done", dict(base, **DONE), 2, False, expect(), {}),
        ("done-seq", dict(base, strategy="sequential", **DONE), 1, False,
         expect(), {}),
        # the leaf route; MLP-128's w1 lies at an odd offset (266), so
        # no launch has every leaf on the vector accesses
        ("microbatch2", dict(base, grad_microbatches=2), R, False,
         expect(sophia_update_leaves=J * R),
         {"sophia_update_leaves": 0}),
        ("bf16-packed", dict(base, comm=CommConfig(**BF16_STATE)), R, True,
         expect(sophia_update_batched=J * R), {"sophia_update_batched": 0}),
        ("fp8-int8-packed", dict(base, comm=CommConfig(**int8, **FP8_STATE)),
         R, True,
         expect(sophia_update_batched=J * R, quant_roundtrip_batched=R),
         {"sophia_update_batched": 0, "quant_roundtrip_batched": R}),
        ("bidir-int8-bf16", dict(base, comm=CommConfig(**bidir,
                                                       **BF16_STATE)),
         2, False,
         expect(broadcast_roundtrip_batched=2, sophia_update_batched=J * 2,
                quant_roundtrip_batched=2 * 2, quant_roundtrip_flat=2),
         {"broadcast_roundtrip_batched": 0, "sophia_update_batched": 0,
          "quant_roundtrip_batched": 2 * 2, "quant_roundtrip_flat": 2}),
    ]
    counts = {}     # phase -> its launch counts (for `time_narrow`)
    for label, kw, rounds, packed, want, forms in phases:
        kw = dict(kw)
        kw.setdefault("strategy", "parallel")
        fed = FedConfig(**kw)
        torch.cuda.reset_peak_memory_stats()
        engine, state, losses, secs = drive(label, mlp, fed, data, rounds,
                                            device, want, packed)
        record(label, secs)
        counts[label] = launch_counts()
        check_forms(label, forms)
        if label in LOSS_FALLS and not losses[-1] < losses[0]:
            raise SystemExit(f"{label}: local loss did not fall: {losses}")
        dtypes = {k: str(t.dtype) for k, t in state_tensors(state).items()}
        steady_s = (sum(secs[1:]) / (len(secs) - 1) if len(secs) > 1
                    else secs[0])
        print(f"{label}: steady seconds per round {steady_s}; "
              f"resident bytes {resident_bytes(state)}; peak device memory "
              f"{torch.cuda.max_memory_allocated()} bytes; dtypes {dtypes}")
        if label in RESIDENT_GATES:
            twin = dataclasses.replace(fed, comm=dataclasses.replace(
                fed.comm, state_dtype="float32", moment_dtype="",
                hessian_dtype=""))
            twin_engine = FedEngine(mlp, twin, device=device)
            twin_state = twin_engine.pack_state(
                twin_engine.init(gen(device, SEED + 3)))
            share = resident_bytes(state) / resident_bytes(twin_state)
            print(f"{label}: resident bytes {resident_bytes(state)} = "
                  f"{share} x the fp32 twin's {resident_bytes(twin_state)} "
                  f"(gate {RESIDENT_GATES[label]})")
            if not share <= RESIDENT_GATES[label]:
                raise SystemExit(f"{label}: resident share {share} above "
                                 f"{RESIDENT_GATES[label]}")

    # host seconds per round of a narrow or FedOpt phase against its twin
    # in one call, in turns (twin, phase, phase, twin): host-clock times
    # spread between calls (PERF.md section 7)
    for label, twin_kw, kw, packed in (
            ("bf16-packed", dict(base), dict(base, comm=CommConfig(
                **BF16_STATE)), True),
            ("fp8-int8-packed", dict(base, comm=CommConfig(**int8)),
             dict(base, comm=CommConfig(**int8, **FP8_STATE)), True),
            ("fedadam", dict(base, optimizer="fedavg"),
             dict(base, optimizer="fedadam"), False),
            ("microbatch2", dict(base), dict(base, grad_microbatches=2),
             False)):
        turns = []
        for cfg in (twin_kw, kw, kw, twin_kw):
            secs = run_rounds(mlp, FedConfig(strategy="parallel", **cfg),
                              data, 3, device, packed)[3]
            turns.append(sum(secs[1:]) / 2)
        print(f"{label}: steady seconds per round in turns (fp32 / fedavg "
              f"/ one-batch twin, phase, phase, twin) {turns}; phase over "
              f"twin {(turns[1] + turns[2]) / (turns[0] + turns[3])}")

    # the health probes: direct, then semisync; each probed run's state
    # bitwise its unprobed twin's, its launches the twin's
    probed = dict(base, strategy="parallel", obs=ObsConfig(probes=True))
    label = "probes"
    want = expect(sophia_update_leaves=J * 2)
    _, state, losses, secs = drive(label, mlp, FedConfig(**probed), data, 2,
                                   device, want)
    record(label, secs)
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: local loss did not fall: {losses}")
    _, twin, _, _ = drive(label + " (unprobed twin)", mlp,
                          FedConfig(**dict(probed, obs=ObsConfig())), data,
                          2, device, want)
    same_state_bits(label, state, twin)
    E = SCHED_EVENTS["semisync"]
    semisync = SchedConfig(discipline="semisync", buffer_size=S, **STRAGGLER)
    want = expect(sophia_update_leaves=J * E, quant_roundtrip_batched=E,
                  stale_accum_flat=E)
    label = "sched-semisync-int8 probes"
    secs, losses, state, trace = drive_sched(
        label, mlp, FedConfig(**dict(probed, comm=CommConfig(**int8),
                                     sched=semisync)), data, E, device, want)
    record(label, [secs])
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: local loss did not fall: {losses}")
    recs = [r for r in trace.to_records() if r["record"] == "sched_event"]
    if not all(k in r and np.isfinite(r[k]) for r in recs
               for k in PROBE_METRICS):
        raise SystemExit(f"{label}: an event record lacks a probe scalar")
    print(f"{label}: probes of the last event "
          f"{ {k: recs[-1][k] for k in PROBE_METRICS} }")
    _, _, twin, _ = drive_sched(
        label + " (unprobed twin)", mlp, FedConfig(**dict(
            base, strategy="parallel", comm=CommConfig(**int8),
            sched=semisync)), data, E, device, want)
    same_state_bits(label, state, twin)

    # FedAdam behind the semisync apply, on bf16 state
    label = "sched-semisync-fedadam-bf16"
    secs, losses, state, _ = drive_sched(
        label, mlp, FedConfig(**dict(
            base, optimizer="fedadam", strategy="parallel",
            comm=CommConfig(**int8, **BF16_STATE), sched=semisync)),
        data, E, device, expect(quant_roundtrip_batched=E,
                                stale_accum_flat=E), packed=True)
    record(label, [secs])
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: local loss did not fall: {losses}")
    print(f"{label}: resident bytes {resident_bytes(state)}; dtypes "
          f"{ {k: str(t.dtype) for k, t in state_tensors(state).items()} }")
    return counts


def check_forms(label, forms):
    """``forms``: entry point -> how many of its launches on the phase
    just run took the fp32 form (the rest took the runtime-dtype form)."""
    for name, n in forms.items():
        got = (tk.F32X4_LAUNCHES if name.startswith("sophia")
               else tq.F32X4_LAUNCHES)[name]
        total = launch_counts()[name]
        if got != n:
            raise SystemExit(f"{label}: {got} of {total} {name} launches "
                             f"took the fp32 form, want {n}")
        print(f"{label}: {name}: {n} of {total} launches on the fp32 form, "
              f"{total - n} on the runtime-dtype form")


def time_narrow(device, launches):
    """The narrow forms the resident dtype policy launches, at the main
    path's shape, each with its plain version (`time_pair`; the bound
    counts each operand's bytes at its own width): row 2 with bf16 m/h
    and with the fp8 regime's e4m3 m / e5m2 h (theta, g, h_hat fp32),
    row 5 with bf16 rows, row 9 with bf16 replicas and residuals (the
    fp32 server model shared; bidir-int8-bf16's S=16 stack).  Each must
    be bitwise its plain version first.  ``launches``: phase -> its
    launch counts."""
    N, R, C = (CLIENTS,) + MLP_PACKED
    out = []
    for tag, m_dt, h_dt, phases in (
            ("bf16 m/h", torch.bfloat16, torch.bfloat16,
             ("bf16-packed", "bidir-int8-bf16")),
            ("fp8 regime: e4m3 m, e5m2 h", torch.float8_e4m3fn,
             torch.float8_e5m2, ("fp8-int8-packed",))):
        ins = sophia_inputs((N, R, C), device, SEED + 97,
                            dtypes=(torch.float32, m_dt, h_dt))
        lr = torch.tensor(LR)
        err = same_bits("narrow", "sophia_update_batched",
                        tk.sophia_update_batched(*ins, 1, lr, **HP),
                        sophia_update_ref(*ins, 1, lr=lr, **HP))
        # the plain version's e4m3 store is a dozen host-side ops: queue
        # fewer of its calls behind one sleep
        t = time_pair(f"sophia_update_batched ({tag})",
                      lambda i: tk.sophia_update_batched(*ins, 1, lr, **HP),
                      lambda i: sophia_update_ref(*ins, 1, lr=lr, **HP),
                      ins, ins[:3], SOPHIA_OPS, plain_chunk=10)
        out.append(dict(name="sophia_update_batched", form=tag,
                        launches=sum(launches[p]["sophia_update_batched"]
                                     for p in phases),
                        max_abs_err=err, **t))
        del ins
    th, _, _, u, s = quant_inputs((N, R, C), device, SEED + 96,
                                  store=torch.bfloat16, shared=True,
                                  qmax=127)
    err = same_bits("narrow", "quant_roundtrip_batched",
                    tq.quant_roundtrip_batched(th, u, s, qmax=127),
                    kref.quant_roundtrip_ref(th, u, s, qmax=127))
    t = time_pair("quant_roundtrip_batched (bf16 rows)",
                  lambda i: tq.quant_roundtrip_batched(th, u, s, qmax=127),
                  lambda i: kref.quant_roundtrip_ref(th, u, s, qmax=127),
                  [th, u, s], [th], QUANT_OPS["quant"], plain_chunk=10)
    out.append(dict(name="quant_roundtrip_batched", form="bf16 rows",
                    launches=0, max_abs_err=err, **t))
    del th, u, s
    h = N // 2
    st, sv, ef, u, s = quant_inputs((h, R, C), device, SEED + 95,
                                    shared=True, qmax=127)
    st, ef = st.to(torch.bfloat16), ef.to(torch.bfloat16)
    err = same_bits("narrow", "broadcast_roundtrip_batched",
                    tq.broadcast_roundtrip_batched(sv, st, ef, u, s,
                                                   qmax=127),
                    kref.broadcast_roundtrip_ref(sv, st, ef, u, s, qmax=127))
    # the kernel writes both outputs in theta's dtype (fp32 here), not
    # in the replicas'; rows 2 and 5 store theirs in their inputs'
    # dtypes (m, h in place; the round-trip like its input)
    outs = [torch.empty_like(st, dtype=sv.dtype) for _ in range(2)]
    t = time_pair("broadcast_roundtrip_batched (bf16 replicas, S=16)",
                  lambda i: tq.broadcast_roundtrip_batched(sv, st, ef, u, s,
                                                           qmax=127),
                  lambda i: kref.broadcast_roundtrip_ref(sv, st, ef, u, s,
                                                         qmax=127),
                  [sv, st, ef, u, s], outs, QUANT_OPS["broadcast"],
                  plain_chunk=10)
    out.append(dict(name="broadcast_roundtrip_batched",
                    form="bf16 replicas",
                    launches=launches["bidir-int8-bf16"][
                        "broadcast_roundtrip_batched"],
                    max_abs_err=err, **t))
    for e in out:
        e.update(route="cuda", source=SOURCES[e["name"]],
                 replaces=REPLACES[e["name"]], library_ms=None)
    return out


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
                attacked=False, packed=False):
    """One scheduler phase: ``events`` aggregation events of a
    `VirtualScheduler` run (donated state, batches per server version),
    with every launch count set to 0 just before it and read just
    after; an ``attacked`` run must fold byzantine arrivals in.  Returns
    host seconds per event (the run ends in a device synchronise) and
    the event losses."""
    x, y, train_idx = data
    engine = FedEngine(task, fed, device=device)
    state = engine.init(gen(device, SEED + 3))
    if packed:
        state = engine.pack_state(state)
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
    return secs, losses, state, trace


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
    whose CUDA route is one launch of the kernel's pytree form) on one
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
    the participants and each stream's U[0, 1) noise by client id (the
    streams that are on), from numpy."""
    rt = engine.runtime_for(state["params"])
    rs = np.random.default_rng(SEED + 700 + r)
    C = s["clients"]
    S = engine.fed.comm.num_participants(C)
    noise = {"participants": np.sort(rs.choice(C, S, replace=False))}
    for stream, spec in (("uplink", rt.spec), ("downlink", rt.spec_dn),
                         ("hessian", rt.spec_h)):
        if spec is not None:
            noise[stream] = rs.uniform(size=(C, spec.rows, spec.cols))
    if rt.spec_h is not None:
        noise["server_hessian"] = rs.uniform(size=(rt.spec_h.rows,
                                                   rt.spec_h.cols))
    return {k: (v if k == "participants" else v.astype(np.float32))
            for k, v in noise.items()}


def state_buffers(state) -> dict:
    """name -> numpy of every resident buffer of a comm-path state (dict
    params flattened in sorted-key order, packed params as they are)."""
    st = convert.state_to_numpy(state)
    params = st["params"]
    if isinstance(params, dict):
        params = np.concatenate([v.reshape(-1) for _, v in
                                 sorted(params.items())])
    out = {"params": params,
           "m": st["client_opt"]["m"], "h": st["client_opt"]["h"]}
    out.update({k: st[k] for k in convert.COMM_KEYS if k in st})
    return out


def flip_band(label, want, got, steps, free=None) -> dict:
    """Raises unless every buffer of ``got`` is within the small band of
    ``want``'s but for at most `SMALL_MAX_FLIPS` coordinates, each
    within one move of the streams that write it (``steps``, from a
    `ScaleProbe`); returns the count outside the band per buffer.
    ``free``: flat coordinates of the params that may each move by a
    flipped Sophia clip (``steps["clip"]``) outside that count, their m
    and h (the EMAs of a gradient that is rounding noise) not held."""
    counts, bad = {}, []
    for name, w in want.items():
        band = SMALL_ATOL + SMALL_RTOL * np.abs(w)
        diff = np.abs(got[name] - w)
        out = diff > band
        if name in ("params", "m", "h") and free is not None and len(free):
            # m and h carry a leading client axis
            lead = 1 if name == "params" else w.shape[0]
            f_out = out.reshape(lead, -1)[:, free]
            if name == "params" and not np.all(
                    diff.reshape(-1)[free][f_out[0]]
                    <= steps["clip"] + band.reshape(-1)[free][f_out[0]]):
                bad.append(f"params: a free coordinate moved past a "
                           f"clipped step {steps['clip']}")
            out = out.copy()
            out.reshape(lead, -1)[:, free] = False
        step = sum(steps.get(st, 0.0) for st in STEPS_OF[name])
        counts[name] = int(out.sum())
        if counts[name] > SMALL_MAX_FLIPS or not np.all(
                diff[out] <= step + band[out]):
            bad.append(f"{name} has {counts[name]} coordinates outside "
                       f"the band, largest {float(diff.max())}, step {step}")
    if bad:
        raise SystemExit(f"{label}: " + "; ".join(bad)
                         + f" (all counts {counts})")
    return counts


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
        flips.append(flip_band(f"small comm {label} {strategy} round {r}",
                               state_buffers(states["cpu"]),
                               state_buffers(states[str(device)]), steps))
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
    nbytes = kcost.launch_bytes(ins, outs_like)
    ops = ops_per_coord * outs_like[0].numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_pair(name, kern, plain, ins, outs_like, ops_per_coord,
              plain_chunk=TIMED_CHUNK, kernel_chunk=TIMED_CHUNK,
              launches=TIMED_LAUNCHES):
    """Device ms of kernel and plain version in turns (plain, kernel,
    kernel, plain), host ms per kernel call, and the bound.  A plain
    version of many launches is queued ``plain_chunk`` calls at a time
    (a kernel entry of costly host work ``kernel_chunk``), so that each
    chunk's enqueue stays within the sleep and within the launch queue
    (past about a thousand pending launches the host blocks behind the
    sleep)."""
    p1, k1, k2, p2 = (time_ms(plain, launches, chunk=plain_chunk),
                      time_ms(kern, launches, chunk=kernel_chunk),
                      time_ms(kern, launches, chunk=kernel_chunk),
                      time_ms(plain, launches, chunk=plain_chunk))
    host = host_ms(kern, launches)
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


def sweep_sophia_grid(device):
    """Device ms of the Sophia kernel's fp32 form at the main path's two
    shapes for each cap on its grid (blocks per SM; "all": a thread per
    float4 group, whatever n), the flat entry walking the 32 client
    slices as in `time_kernels`.  Sets nothing: the wrapper's cap is
    chosen from these numbers by hand."""
    N, R, C = (CLIENTS,) + MLP_PACKED
    ins = sophia_inputs((N, R, C), device, SEED + 99)
    keep = tk.F32X4_BLOCKS_PER_SM
    try:
        for cap in (2, 4, 8, 16, 32, None):
            tk.F32X4_BLOCKS_PER_SM = cap or 1 << 20
            flat = time_ms(lambda i: tk.sophia_update_flat(
                *(x[i % N] for x in ins), 1, LR, **HP))
            batched = time_ms(lambda i: tk.sophia_update_batched(
                *ins, 1, LR, **HP))
            grids = [tk.f32x4_blocks(n, device) for n in (R * C, N * R * C)]
            print(f"sophia fp32 form, blocks per SM {cap or 'all'} (grids "
                  f"{grids[0]}, {grids[1]}): flat {flat} ms, batched "
                  f"{batched} ms")
    finally:
        tk.F32X4_BLOCKS_PER_SM = keep


def sweep_quant_grid(device):
    """Device ms of the quant round-trip's fp32 form at the main path's
    shapes for each block size (a thread per float4 group), the flat
    entry walking the 32 client slices as in `time_kernels`, the batched
    entry on the whole stack.  Sets nothing: the wrapper's block size is
    chosen from these numbers by hand."""
    N, (R, C) = CLIENTS, MLP_PACKED
    th, _, _, u, s = quant_inputs((N, R, C), device, SEED + 98, qmax=127)
    keep = tq.F32X4_THREADS
    try:
        for threads in (64, 128, 256, 512):
            tq.F32X4_THREADS = threads
            flat = time_ms(lambda i: tq.quant_roundtrip_flat(
                th[i % N], u[i % N], s[i % N], qmax=127))
            batched = time_ms(lambda i: tq.quant_roundtrip_batched(
                th, u, s, qmax=127))
            grids = [-(-(n * C // 4) // threads) for n in (R, N * R)]
            print(f"quant fp32 form, {threads} threads a block (grids "
                  f"{grids[0]}, {grids[1]}): flat {flat} ms, batched "
                  f"{batched} ms")
    finally:
        tq.F32X4_THREADS = keep


def sweep_uplink_grid(device):
    """Device ms of the uplink round-trip's fp32 form at the main path's
    shapes for each block size (a thread per float4 group), the flat
    entry walking the 32 client slices with per-client starts as in
    `time_kernels`, the batched entry on the whole stack with the shared
    start.  Sets nothing: the wrapper's block size is chosen from these
    numbers by hand."""
    N, (R, C) = CLIENTS, MLP_PACKED
    th, sv, ef, u, s = quant_inputs((N, R, C), device, SEED + 98, qmax=127)
    st = th.flip(0).contiguous()
    keep = tq.UPLINK_F32X4_THREADS
    try:
        for threads in (64, 128, 256, 512):
            tq.UPLINK_F32X4_THREADS = threads
            flat = time_ms(lambda i: tq.uplink_roundtrip_flat(
                th[i % N], st[i % N], ef[i % N], u[i % N], s[i % N],
                qmax=127))
            batched = time_ms(lambda i: tq.uplink_roundtrip_batched(
                th, sv, ef, u, s, qmax=127))
            grids = [-(-(n * C // 4) // threads) for n in (R, N * R)]
            print(f"uplink fp32 form, {threads} threads a block (grids "
                  f"{grids[0]}, {grids[1]}): flat {flat} ms, batched "
                  f"{batched} ms")
    finally:
        tq.UPLINK_F32X4_THREADS = keep


def sweep_broadcast_grid(device):
    """Device ms of the broadcast round-trip's fp32 form at the main
    path's shapes for each block size (a thread per float4 group), the
    flat entry walking the 32 client replicas with the one server model as
    in `time_kernels`, the batched entry on the 16-client replica stack
    with the shared server model (the bidir phase's S=16).  Sets nothing:
    the wrapper's block size is chosen from these numbers by hand."""
    N, (R, C) = CLIENTS, MLP_PACKED
    h = N // 2
    th, sv, ef, u, s = quant_inputs((N, R, C), device, SEED + 98, qmax=127)
    st = th.flip(0).contiguous()
    keep = tq.BROADCAST_F32X4_THREADS
    try:
        for threads in (64, 128, 256, 512):
            tq.BROADCAST_F32X4_THREADS = threads
            flat = time_ms(lambda i: tq.broadcast_roundtrip_flat(
                sv, st[i % N], ef[i % N], u[i % N], s[i % N], qmax=127))
            batched = time_ms(lambda i: tq.broadcast_roundtrip_batched(
                sv, st[:h], ef[:h], u[:h], s[:h], qmax=127))
            grids = [-(-(n * C // 4) // threads) for n in (R, h * R)]
            print(f"broadcast fp32 form, {threads} threads a block (grids "
                  f"{grids[0]}, {grids[1]}): flat {flat} ms, batched "
                  f"(S={h}) {batched} ms")
    finally:
        tq.BROADCAST_F32X4_THREADS = keep


def sweep_biased_grid(device):
    """Device ms of the sign and threshold kernels' fp32 form at the
    main path's shapes for each block size (a thread per float4 group):
    the flat entries walking the 32 client slices as in `time_kernels`,
    the batched entries on the 32- and the 16-client stack.  Sets
    nothing: the wrapper's block size is chosen from these numbers by
    hand."""
    N, (R, C) = CLIENTS, MLP_PACKED
    h = N // 2
    x, v = biased_inputs((N, R, C), device, SEED + 97)
    keep = tq.BIASED_F32X4_THREADS
    try:
        for threads in (64, 128, 256, 512):
            tq.BIASED_F32X4_THREADS = threads
            grids = [-(-(n * R * C // 4) // threads) for n in (1, N, h)]
            for fn in ("sign_roundtrip", "topk_threshold"):
                flat, batched = (getattr(tq, f"{fn}_{k}")
                                 for k in ("flat", "batched"))
                t1 = time_ms(lambda i: flat(x[i % N], v[i % N]))
                tn = time_ms(lambda i: batched(x, v))
                th_ = time_ms(lambda i: batched(x[:h], v[:h]))
                print(f"{fn} fp32 form, {threads} threads a block (grids "
                      f"{grids[0]}, {grids[1]}, {grids[2]}): flat {t1} ms, "
                      f"batched x{N} {tn} ms, x{h} {th_} ms")
    finally:
        tq.BIASED_F32X4_THREADS = keep


def time_kernels(device):
    """Every kernel and its plain version at the main path's shapes,
    fp32.  A flat entry walks the 32 client slices of a stack in turn,
    so each launch finds its buffers outside the 50 MB L2, as the
    sequential strategy does; the batched entries run on the whole stack
    (32 clients; 16 for the downlink of the bidir path, where half the
    clients take part), and the 16-client ones also walk copies past the
    L2 (`time_past_l2`)."""
    sweep_sophia_grid(device)
    sweep_quant_grid(device)
    sweep_uplink_grid(device)
    sweep_broadcast_grid(device)
    sweep_biased_grid(device)
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
    # the leaf-boundary form over MLP-128's cohort: fp32 grad leaves, the
    # zero h_hat buffer, no params store (fp32 leaves are views of theta)
    mlp = MLPTask(hidden=mlp_mnist.HIDDEN).init(gen(device, SEED), device)
    spec, th, m, h, g, _, zero = leaf_inputs(device, SEED + 97, mlp, (N,))
    out["sophia_update_leaves"] = time_pair(
        "sophia_update_leaves",
        lambda i: tk.sophia_update_leaves(th, m, h, g, zero, 1, lr,
                                          spec=spec, **HP),
        lambda i: kref.sophia_update_leaves_ref(th, m, h, g, zero, 1.0,
                                                spec=spec, out_dtypes={},
                                                lr=lr, **HP),
        [th, m, h, *g.values(), zero], [th, m, h], SOPHIA_OPS,
        # the plain version's pack and ops take about 1 ms of host time
        # a call: 50 calls outlast the sleep that holds a chunk back
        plain_chunk=10, kernel_chunk=10)
    del th, m, h, g, zero
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
    time_past_l2(device)
    out.update(time_slice4(device))
    return out


def copies_past_l2(tensors, l2_bytes=50 * 2 ** 20):
    """Copies of ``tensors``, enough sets to exceed the 50 MB L2
    together, so that calls that walk them in turn read from device
    memory."""
    one = sum(t.numel() * t.element_size() for t in tensors)
    return [[t.clone() for t in tensors] for _ in range(l2_bytes // one + 2)]


def time_past_l2(device):
    """Rows 5, 9, 11 and 13 at 16 clients, each call on the next of a
    set of copies that exceeds the L2 (a 16-client stack, 7.6 to 23 MB a
    call, stays in the 50 MB L2 when one stack is re-read): device-memory
    readings, under labels of their own (``..., HBM``)."""
    N, R, C = (CLIENTS // 2,) + MLP_PACKED
    q = 127
    th, sv, ef, u, s = quant_inputs((N, R, C), device, SEED + 96, qmax=q)
    sets = copies_past_l2([th, u, s])
    n = len(sets)
    time_pair("quant_roundtrip_batched (hessian, S=16, HBM)",
              lambda i: tq.quant_roundtrip_batched(*sets[i % n], qmax=7),
              lambda i: kref.quant_roundtrip_ref(*sets[i % n], qmax=7),
              [th, u, s], [th], QUANT_OPS["quant"])
    sets = copies_past_l2([sv, th, ef, u, s])
    n = len(sets)
    time_pair("broadcast_roundtrip_batched (S=16, HBM)",
              lambda i: tq.broadcast_roundtrip_batched(*sets[i % n], qmax=q),
              lambda i: kref.broadcast_roundtrip_ref(*sets[i % n], qmax=q),
              [sv, th, ef, u, s], [th, th], QUANT_OPS["broadcast"])
    del sets, th, sv, ef, u, s
    x, v = biased_inputs((N, R, C), device, SEED + 95)
    sets = copies_past_l2([x, v])
    n = len(sets)
    for name, ops_ in (("sign_roundtrip", BIASED_OPS["sign"]),
                       ("topk_threshold", BIASED_OPS["topk"])):
        kern = getattr(tq, f"{name}_batched")
        plain = getattr(kref, f"{name}_ref")
        time_pair(f"{name}_batched (S=16, HBM)",
                  lambda i: kern(*sets[i % n]), lambda i: plain(*sets[i % n]),
                  [x, v], [x], ops_)


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


def sweep_stale_grid(device):
    """Device ms of the stale accumulate's fp32 form at the main path's
    K=16 and K=1 for each block size (a thread per float4 group), each
    call on the next of a set of stacks past the L2 as in
    `time_slice4`.  Sets nothing: the wrapper's block size is chosen from
    these numbers by hand."""
    keep = tstale.THREADS
    try:
        for K in (16, 1):
            xs, w, _ = timing_stacks(K, device, SEED + 500 + K)
            inv = torch.tensor([inv_sum(w)], device=device)
            n = len(xs)
            for threads in (64, 128, 256):
                tstale.THREADS = threads
                t = time_ms(lambda i: tstale.stale_accum_flat(xs[i % n], w,
                                                              inv))
                grid = -(-(MLP_PACKED[0] * MLP_PACKED[1] // 4) // threads)
                print(f"stale_accum fp32 form, K={K}, {threads} threads a "
                      f"block (grid {grid}): {t} ms")
            del xs
    finally:
        tstale.THREADS = keep


def time_stale_wires(device):
    """The stale accumulate at K=16 over bf16, e4m3 and e5m2 wires (its
    one-coordinate form), each call on the next of a set of stacks past
    the L2; calls only what every version of the package has, so
    `tools/ab_kernel_times.py --harness` can time an older checkout's
    kernel with it."""
    agg_out = [torch.empty(MLP_PACKED, device=device)]
    xs, w, _ = timing_stacks(16, device, SEED + 516)
    inv = torch.tensor([inv_sum(w)], device=device)
    for store in STORES[1:]:
        one = xs[0].numel() * torch.finfo(store).bits // 8
        n = 50 * 2 ** 20 // one + 2
        ws = [xs[k % len(xs)].to(store) for k in range(n)]
        time_pair(f"stale_accum_flat (K=16, {str(store)[6:]} wires)",
                  lambda i: tstale.stale_accum_flat(ws[i % n], w, inv),
                  lambda i: kref.stale_accum_ref(ws[i % n], w, inv),
                  [ws[0], w], agg_out, stale_ops(16), plain_chunk=10)
        del ws


def time_stale(device):
    """Row 14 and its plain version at the main path's shapes, fp32: the
    stale accumulate at K=16 (semisync's buffer; the row's headline) and
    K=1 (async), beside ``torch.tensordot(w, wires, dims=1) *
    inv_norm``, the one library call of the same function (not bitwise:
    cuBLAS's GEMV sums in its own order); then over narrow wires
    (`time_stale_wires`).  Calls only what every version of the package
    has (`tools/ab_kernel_times.py --harness`)."""
    out = {}
    agg_out = [torch.empty(MLP_PACKED, device=device)]
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
    time_stale_wires(device)
    return out


def time_slice4(device):
    """Rows 3, 14 and 15 and their plain versions at the main path's
    shapes, fp32: the stale accumulate's grid sweep and `time_stale`;
    the robust combine at K=32 trim 8 (the trimmed mean of the direct
    phase; the headline), K=32 trim 15 (the median), K=16 trim 4 (the
    comm round's trimmed mean at S=16) and K=16 trim 0 with clip scales
    (norm-clip), beside ``torch.sort(wires, dim=0)``, the library's sort
    along K (the kernel sorts a register copy per coordinate instead; no
    library call computes the combine); the pytree step on the MLP-128
    trees."""
    sweep_stale_grid(device)
    out = time_stale(device)
    R, C = MLP_PACKED
    agg_out = [torch.empty((R, C), device=device)]
    for K, trim, clip in ((32, 8, False), (32, 15, False), (16, 4, False),
                          (16, 0, True)):
        xs, w, sc = timing_stacks(K, device, SEED + 600 + K + trim)
        if not clip:
            sc = torch.ones_like(sc)
        n = len(xs)
        share = float(sum(sort_form_share(x, sc) for x in xs)) / n
        print(f"robust_agg_flat (K={K}, trim={trim}): sort form at {share} "
              f"of coordinates; {robust_ops(K, trim, share)} operations a "
              f"coordinate ({robust_ops(K, trim, 0.0)} in the pass form)")
        t = time_pair(f"robust_agg_flat (K={K}, trim={trim}"
                      f"{', clip scales' if clip else ''})",
                      lambda i: trobust.robust_agg_flat(xs[i % n], w, sc,
                                                        trim=trim),
                      lambda i: kref.robust_agg_ref(xs[i % n], w, sc,
                                                    trim=trim),
                      [xs[0], w, sc], agg_out, robust_ops(K, trim, share),
                      plain_chunk=2)
        sort_ms = time_ms(lambda i: torch.sort(xs[i % n], dim=0))
        t["library_ms"] = None
        print(f"robust_agg_flat (K={K}, trim={trim}): torch.sort(wires, "
              f"dim=0), the library's sort along K, {sort_ms} ms")
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


# ------------------------------------------------------------ LM training
#: slice 10's path, through the trainer's CLI (`repro_torch.launch.train`):
#: minicpm-2b at its published widths (d_model 2304, 36 heads of 64, d_ff
#: 5760, vocab 122,753 padded to 122,880), the depth cut 40 -> 2 layers
#: (``--layers``); 4 clients, J=2, tau=2, batch 2, seq 256, the arch's
#: FED overrides (parallel, WSD), fp32 resident state, bf16 parameters
LM_ARCH, LM_LAYERS = "minicpm-2b", 2
LM_PARAMS, LM_PACKED = 405_220_608, (395_724, 1024)
LM_CLIENTS, LM_ITERS, LM_TAU, LM_BATCH, LM_SEQ = 4, 2, 2, 2, 256
LM_ROUNDS, LM_RESUME_ROUNDS = 3, 1
#: slice 11's sequential path: gemma2-9b (arXiv:2408.00118) at its
#: published widths (d_model 3584, 16 heads of 256, 8 kv heads, d_ff
#: 14336 GeGLU, vocab 256,000 tied, both softcaps, post-norms), the
#: depth cut 42 -> 2 layers (one local block, window 4096, one global),
#: on its arch's FED strategy (sequential), int8 uplink, 2 clients
SEQ_ARCH = "gemma2-9b"
SEQ_PARAMS, SEQ_PACKED = 1_313_897_984, (1_283_104, 1024)
SEQ_CLIENTS = 2
#: slice 12's MoE path: deepseek-v2-lite-16b (arXiv:2405.04434) at its
#: published widths (d_model 2048, 16 heads; MLA: kv_lora 512, q/k heads
#: of 128 + a 64-wide RoPE part, v heads of 128; 64 routed experts of
#: d_ff 1408, top-6, 2 shared; vocab 102,400 untied), every layer MoE
#: (the JAX config's), the depth cut 27 -> 2 layers, on its arch's FED
#: strategy (sequential), int8 uplink, 2 clients
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_PARAMS, MOE_PACKED = 1_589_128_192, (1_551_883, 1024)
MOE_CLIENTS = 2
#: slice 13's recurrent paths, each on its arch's FED strategy (parallel),
#: int8 uplink, 2 clients (C=4 fits neither): recurrentgemma-2b
#: (arXiv:2402.19427) at its published widths (d_model 2560, RG-LRU width
#: 2560 with a 4-tap conv, 10 heads of 256 with one kv head, window 2048,
#: d_ff 7680 GeGLU, vocab 256,000 tied, scale_emb sqrt(2560)), the depth
#: cut 26 -> 3 layers (one (rec, rec, local) pattern); xlstm-1.3b
#: (arXiv:2405.04517: d_model 2048, 4 heads; mLSTM width 4096, heads of
#: 1024; sLSTM heads of 512, up-projection 2730; d_ff 0, FFN-less blocks;
#: vocab 50,304 untied), the depth cut 48 -> 8 layers (one (m x 7, s)
#: pattern); seq 256 is two mLSTM chunks
REC_ARCH, REC_LAYERS = "recurrentgemma-2b", 3
REC_PARAMS, REC_PACKED = 912_314_880, (890_933, 1024)
XLSTM_ARCH, XLSTM_LAYERS = "xlstm-1.3b", 8
XLSTM_PARAMS, XLSTM_PACKED = 773_169_208, (755_049, 1024)
REC_CLIENTS = 2
#: slice 14's embedding-input paths, parallel (their FED), int8 uplink:
#: hubert-xlarge (arXiv:2106.07447: d_model 1280, 16 heads, d_ff 5120
#: GeLU, vocab 504 untied; a bidirectional encoder on frame embeddings)
#: at its full 48 layers, 2 clients (reckoned near 60 GB); qwen2-vl-2b
#: (arXiv:2409.12191: d_model 1536, 12 heads of 128 with 2 kv heads,
#: M-RoPE sections 16 / 24 / 24, d_ff 8960 SwiGLU, vocab 151,936 tied;
#: on patch embeddings) cut 28 -> 2 layers, 4 clients
ENC_ARCH, ENC_LAYERS = "hubert-xlarge", 48
ENC_PARAMS, ENC_PACKED = 945_153_280, (923_002, 1024)
VLM_ARCH, VLM_LAYERS = "qwen2-vl-2b", 2
VLM_PARAMS, VLM_PACKED = 327_163_392, (319_496, 1024)
VLM_CLIENTS = 4
#: the LM phases through the CLI: (arch, layers, parameters, packed
#: shape, clients, extra flags, launches of a run of r rounds).
#: Launches, from `FedEngine._round_comm` / `_round_direct`: each local
#: step one Sophia launch over the cohort (parallel: row 2) or one a
#: client (sequential: row 1); the int8 uplink with EF off one quant
#: round-trip over the cohort's deltas (row 5) or one a client (row 4)
LM_PHASES = {
    "lm_train": (LM_ARCH, LM_LAYERS, LM_PARAMS, LM_PACKED, LM_CLIENTS, (),
                 lambda r: expect(sophia_update_leaves=r * LM_ITERS)),
    "lm_comm": (LM_ARCH, LM_LAYERS, LM_PARAMS, LM_PACKED, LM_CLIENTS,
                ("--compressor", "int8"),
                lambda r: expect(sophia_update_leaves=r * LM_ITERS,
                                 quant_roundtrip_batched=r)),
    "lm_seq": (SEQ_ARCH, LM_LAYERS, SEQ_PARAMS, SEQ_PACKED, SEQ_CLIENTS,
               ("--compressor", "int8"),
               lambda r: expect(
                   sophia_update_leaves=r * SEQ_CLIENTS * LM_ITERS,
                   quant_roundtrip_flat=r * SEQ_CLIENTS)),
    "lm_moe": (MOE_ARCH, LM_LAYERS, MOE_PARAMS, MOE_PACKED, MOE_CLIENTS,
               ("--compressor", "int8"),
               lambda r: expect(
                   sophia_update_leaves=r * MOE_CLIENTS * LM_ITERS,
                   quant_roundtrip_flat=r * MOE_CLIENTS)),
    "lm_rec": (REC_ARCH, REC_LAYERS, REC_PARAMS, REC_PACKED, REC_CLIENTS,
               ("--compressor", "int8"),
               lambda r: expect(sophia_update_leaves=r * LM_ITERS,
                                quant_roundtrip_batched=r)),
    "lm_xlstm": (XLSTM_ARCH, XLSTM_LAYERS, XLSTM_PARAMS, XLSTM_PACKED,
                 REC_CLIENTS, ("--compressor", "int8"),
                 lambda r: expect(sophia_update_leaves=r * LM_ITERS,
                                  quant_roundtrip_batched=r)),
    "lm_enc": (ENC_ARCH, ENC_LAYERS, ENC_PARAMS, ENC_PACKED, REC_CLIENTS,
               ("--compressor", "int8"),
               lambda r: expect(sophia_update_leaves=r * LM_ITERS,
                                quant_roundtrip_batched=r)),
    "lm_vlm": (VLM_ARCH, VLM_LAYERS, VLM_PARAMS, VLM_PACKED, VLM_CLIENTS,
               ("--compressor", "int8"),
               lambda r: expect(sophia_update_leaves=r * LM_ITERS,
                                quant_roundtrip_batched=r)),
}
#: the phases whose resumed round (round 0's batches again: the CLI
#: salts batches by the run's round index) must give a loss below the
#: first run's round 0: the model learnt those batches.  Over the first
#: run's rounds, new batches each, the loss need not fall at lr 1e-3
LM_RELEARN = ("lm_moe", "lm_rec", "lm_xlstm")
#: what each LM phase measured, for `dry_check`: the CLI's argv, the
#: first run's launch counts and peak, the reckoned peak and the profiled
#: round's device time (us)
LM_MEASURED: dict = {}
#: the profiler ranges of a profiled LM round whose device time is read,
#: each with the block kind that runs it (None: the MoE FFN): the MoE's
#: dispatch / combine einsums and each recurrent mixer's scan (forward
#: and backward)
LM_SPANS = {ROUTE_SPAN: ("MoE dispatch / combine einsums", None),
            RGLRU_SPAN: ("RG-LRU scans", "rec"),
            MLSTM_SPAN: ("mLSTM chunk scans", "m"),
            SLSTM_SPAN: ("sLSTM step loops", "s")}
#: the fp32 leaves of a bf16 model (the MoE routers, the RG-LRU's decay,
#: the mLSTM's gates, the sLSTM's gate biases), by the ends of their keys
FP32_LEAVES = ("/router", "/lam", "/w_if", "/b_if", "/b_gates")
#: the kernels of a profiled LM round, by words of the device activity's
#: name: the Sophia update (rows 1-2) and the quantize round-trip (4-5)
LM_KERNEL_WORDS = {"Sophia (rows 1-2)": "sophia",
                   "quant round-trip (rows 4-5)": "quant_roundtrip"}


def lm_batches(cfg, generator, clients, batch, seq, device):
    """A round's token batches, and for an embedding-input config N(0, 1)
    ``embeds`` in its dtype in place of the tokens (the CLI's form)."""
    b = syn.make_token_batch(generator, clients, batch, seq, cfg.vocab_size,
                             device=device)
    if cfg.embedding_inputs:
        b = {"embeds": torch.randn(
            (clients, batch, seq, cfg.d_model), generator=generator,
            device=generator.device).to(getattr(torch, cfg.dtype)).to(
                device), "labels": b["labels"]}
    return b


def lm_argv(arch, layers, clients, ckpt_dir, rounds, *extra):
    return ["--arch", arch, "--layers", str(layers),
            "--rounds", str(rounds), "--clients", str(clients),
            "--local-iters", str(LM_ITERS), "--tau", str(LM_TAU),
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
            "--ckpt-dir", str(ckpt_dir), "--seed", str(SEED), *extra]


def block_inputs(cfg, clients, batch, seq):
    """Under remat (``cfg.train_remat``, the default) the backward keeps
    each block's input, ``(clients, batch, seq, d_model)`` in the
    parameters' dtype, and recomputes one block at a time: ``(name,
    bytes)`` pairs (none without remat)."""
    if not cfg.train_remat:
        return []
    width = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return [(f"{cfg.num_layers} blocks' inputs kept for the recompute",
             cfg.num_layers * clients * batch * seq * cfg.d_model * width)]


def reckon_seq_peak(cfg, n_params, packed_shape, clients, logits_shape):
    """The peak of a sequential LM round (`FedEngine._sophia_loop` of one
    client, the others' state resident), reckoned by buffer before the
    run: ``(name, bytes)`` pairs.  P is one fp32 buffer in wire layout.
    Resident: server θ (P), m and h of every client (2·C·P); while one
    client trains: its θ (P), the zero ĥ of steps without a refresh (P),
    the packed grads (P) and GNB estimate (P), the params view and its
    grads (bf16: P/2 each), the running client sum of the round (P);
    the logits with their softmax and grad (fp32, three copies); under
    remat each block's input (`block_inputs`)."""
    P = packed_shape[0] * packed_shape[1] * 4
    logits = 4 * int(np.prod(logits_shape))
    return [("server θ", P), (f"m and h of {clients} clients",
                              2 * clients * P),
            ("client θ", P), ("zero ĥ", P), ("packed grads", P),
            ("packed GNB estimate", P),
            ("params view and its grads (bf16)", 4 * n_params),
            ("client sum of the round", P),
            ("logits, softmax and grad (fp32)", 3 * logits)] + block_inputs(
                cfg, 1, *logits_shape[:2])


def reckon_par_peak(cfg, n_params, packed_shape, clients, batch, seq):
    """The peak of a parallel LM round (`FedEngine._sophia_loop` over the
    cohort's stacks) by buffer, reckoned before the run as the buffers of
    a GNB refresh step all alive at once: ``(name, bytes)`` pairs.  P is
    one fp32 buffer in wire layout, C the clients.  Resident: server θ
    (P), m and h of every client (2·C·P); the step: the cohort's θ stack
    (C·P), the zero ĥ of steps without a refresh (C·P), the packed loss
    grads (C·P), the packed GNB estimate (C·P), the params view (bf16:
    C·P/2), the GNB's grads and their squares (bf16: C·P); the
    vocab-wide fp32 tensors of a loss (logits, the pad-masked copy, the
    gumbel noise, their sum, the CE grad); the mLSTM's fp32 (dh, dh)
    carries the backward keeps, three a head, chunk, layer, sequence and
    client: under remat (the default) those of the one block being
    recomputed, with each block's input (`block_inputs`), else every
    mLSTM layer's."""
    P = packed_shape[0] * packed_shape[1] * 4
    C = clients
    vocab = 4 * C * batch * seq * cfg.vocab_padded
    n_m = (cfg.pattern_reps * cfg.block_pattern.count("m")
           + cfg.pattern_remainder.count("m"))
    H = cfg.num_heads
    dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    carries = 3 * 4 * C * batch * H * dh * dh * max(
        seq // MLSTM_CHUNK, 1) * n_m
    parts = [("server θ", P), (f"m and h of {C} clients", 2 * C * P),
             ("cohort θ", C * P), ("zero ĥ", C * P),
             ("packed grads", C * P), ("packed GNB estimate", C * P),
             ("params view (bf16)", 2 * C * n_params),
             ("GNB grads and their squares (bf16)", 4 * C * n_params),
             ("vocab-wide fp32 tensors of a loss (five)", 5 * vocab)]
    if n_m:
        kept = 1 if cfg.train_remat else n_m
        parts.append((f"mLSTM carries kept for backward ({kept} of {n_m} "
                      f"layers)", carries // n_m * kept))
    return parts + block_inputs(cfg, C, batch, seq)


def lm_phase(label, device, hooks=None):
    """One LM phase of `LM_PHASES` through ``repro_torch.launch.train.
    main`` (given ``hooks``, its test seam: ``cfg`` maps the phase's
    model config, as ``ab_rounds.py`` does to train without remat):
    `LM_ROUNDS` rounds with ``--obs-log`` (a flush a round) and
    ``--ckpt-dir``, then `LM_RESUME_ROUNDS` resumed from that checkpoint.
    Gates: exact launch counts of each run, finite losses, every record
    valid under the port's schema with its fingerprint in the log's and
    the run manifest's head, the chrome trace of the log valid, the
    checkpoint restored bitwise the params it saved.  Prints steady
    seconds per round, peak memory, the checkpoint's save and restore
    times with its bytes (host clock after a synchronise) and one
    profiled round.  Returns the launch counts summed over both runs."""
    import tempfile
    from repro_torch import obs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    (arch, layers, n_params, packed_shape, clients, flags,
     want_of) = LM_PHASES[label]
    card = card_info()
    launches = {name: 0 for name in REPLACES}
    from repro_torch.configs import get_fed_overrides, get_model_config
    cfg = dataclasses.replace(get_model_config(arch), num_layers=layers)
    cfg = (hooks or {}).get("cfg", lambda c: c)(cfg)
    if get_fed_overrides(arch).get("strategy") == "sequential":
        parts = reckon_seq_peak(cfg, n_params, packed_shape, clients,
                                (LM_BATCH, LM_SEQ, cfg.vocab_padded))
    else:
        parts = reckon_par_peak(cfg, n_params, packed_shape, clients,
                                LM_BATCH, LM_SEQ)
    reckoned = sum(b for _, b in parts)
    print(f"{label}: reckoned peak {reckoned} bytes: " + "; ".join(
        f"{name} {b}" for name, b in parts))
    with tempfile.TemporaryDirectory(prefix=f"{label}_") as tmp:
        tmp = Path(tmp)
        log = tmp / "run.jsonl"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        argv = lm_argv(arch, layers, clients, tmp / "ckpt", LM_ROUNDS,
                       *flags, "--obs-log", str(log), "--obs-flush-every",
                       "1")
        res = train.main(argv, hooks=hooks)
        got = launch_counts()
        want = want_of(LM_ROUNDS)
        print(f"{label}: launches {got}")
        if got != want:
            raise SystemExit(f"{label}: launches {got}, want {want}")
        for k, v in got.items():
            launches[k] += v
        peak = torch.cuda.max_memory_allocated()
        engine, state = res["engine"], res["state"]
        spec = engine.runtime_for(state["params"]).spec
        packed = tuple(state["client_opt"].m.shape[1:])
        if spec.total != n_params or packed != packed_shape:
            raise SystemExit(f"{label}: {spec.total} parameters packed "
                             f"as {packed}")
        losses, secs = res["losses"], res["seconds"]
        if len(losses) != LM_ROUNDS or not all(np.isfinite(losses)):
            raise SystemExit(f"{label}: losses {losses}")
        steady = sum(secs[1:]) / len(secs[1:])
        fed = engine.fed
        print(f"{label}: {arch} x {layers} layers, {n_params} "
              f"parameters packed {packed}, {clients} clients, "
              f"{fed.strategy}, compressor {fed.comm.compressor}, "
              f"J={LM_ITERS}: losses {losses}; seconds per round {secs}; "
              f"steady seconds per round (rounds 1-{LM_ROUNDS - 1}) "
              f"{steady}; peak device memory {peak} bytes; {card}")
        print(f"{label}: peak {peak} bytes against the reckoned "
              f"{reckoned} ({(reckoned - peak) / 1e9} GB under)")
        if peak > reckoned:
            raise SystemExit(f"{label}: peak {peak} bytes above the "
                             f"reckoned {reckoned}")

        recs = obs.read_records(str(log))
        for rec in recs:
            obs.validate_record(rec)
        head = recs[0]
        run_manifest = json.loads(Path(str(log) + ".manifest.json")
                                  .read_text())
        if (head.get("record") != "manifest"
                or head["schema_sha256"] != obs.fingerprint()
                or run_manifest["schema_sha256"] != obs.fingerprint()):
            raise SystemExit(f"{label}: the log does not carry the "
                             "schema fingerprint")
        rounds = [r for r in recs if r["record"] == "round"]
        if ([r["round"] for r in rounds] != list(range(LM_ROUNDS))
                or [r["loss"] for r in rounds] != losses):
            raise SystemExit(f"{label}: round records {rounds}")
        errors = obs.validate_chrome_trace(obs.chrome_trace(recs))
        if errors:
            raise SystemExit(f"{label}: chrome trace invalid: {errors}")
        print(f"{label}: {len(recs)} records valid (schema "
              f"{head['schema_sha256'][:12]}), chrome trace valid")

        saved = tflat.unpack(state["params"], spec)
        manifest = ckpt.load_manifest(str(tmp / "ckpt"))
        sync()
        t0 = time.perf_counter()
        restored = ckpt.restore(str(tmp / "ckpt"), saved)
        sync()
        restore_s = time.perf_counter() - t0
        for k, v in saved.items():
            if (restored[k].dtype != v.dtype
                    or not torch.equal(bits(restored[k]), bits(v))):
                raise SystemExit(f"{label}: checkpoint leaf {k} is not "
                                 "bitwise the saved params")
        fp32_leaves = [k for k in saved if k.endswith(FP32_LEAVES)]
        wants_fp32 = (engine.task.cfg.moe is not None or set(
            engine.task.cfg.block_pattern) & {"rec", "m", "s"})
        if wants_fp32 and (not fp32_leaves or any(
                saved[k].dtype != torch.float32
                or manifest["dtypes"][k] != "float32"
                for k in fp32_leaves)):
            raise SystemExit(f"{label}: leaves {fp32_leaves} are not fp32 "
                             "in the params and the checkpoint")
        if (manifest["step"] != LM_ROUNDS
                or manifest["extra"]["wire"]
                != engine.wire_headers(state["params"])):
            raise SystemExit(f"{label}: checkpoint manifest {manifest}")
        saved_ck = res["ckpt"]
        print(f"{label}: checkpoint of {len(saved)} leaves restored "
              f"bitwise; save {saved_ck['save_s']} s for "
              f"{saved_ck['save_bytes']} bytes of arrays "
              f"({saved_ck['save_bytes'] / saved_ck['save_s'] / 1e9} GB/s), "
              f"restore {restore_s} s ({saved_ck['save_bytes'] / restore_s / 1e9} "
              f"GB/s; host clock after a synchronise); {card}")
        del restored, saved

        cfg = engine.task.cfg
        batches = lm_batches(cfg, gen(device, SEED + 7), clients, LM_BATCH,
                             LM_SEQ, device)
        by_name, span_us = profile_call(
            lambda: engine.round(state, batches,
                                 generator=gen(device, SEED + 8)), steady,
            top=16, spans=tuple(LM_SPANS))
        busy = sum(t for t, _ in by_name.values())
        LM_MEASURED[label] = dict(argv=argv, launches=got, peak=peak,
                                  reckoned=reckoned, device_us=busy)
        print(f"{label}: remat {cfg.train_remat}: steady seconds per round "
              f"{steady}, busy share {busy / (steady * 1e6)}, peak {peak} "
              f"bytes (reckoned {reckoned}); {card}")
        for span, (what, kind) in LM_SPANS.items():
            if not (cfg.moe is not None if kind is None
                    else kind in cfg.block_pattern):
                continue
            if not span_us[span]:
                raise SystemExit(f"{label}: the profile shows no {what} "
                                 "range")
            print(f"{label}: profiled round: {what} (forward and "
                  f"backward, every layer, client and step) "
                  f"{span_us[span]} us of device activities in their "
                  f"ranges ({span_us[span] / busy} of device time); "
                  f"{card}")
        for what, word in LM_KERNEL_WORDS.items():
            hits = [(t, n) for name, (t, n) in by_name.items()
                    if word in name.lower()]
            print(f"{label}: profiled round: {what} "
                  f"{sum(n for _, n in hits)} launches, "
                  f"{sum(t for t, _ in hits)} us of device time; {card}")
        del res, engine, state, batches
        torch.cuda.empty_cache()

        reset_launches()
        res = train.main(lm_argv(arch, layers, clients, tmp / "ckpt",
                                 LM_RESUME_ROUNDS, *flags, "--resume"),
                         hooks=hooks)
        got = launch_counts()
        want = want_of(LM_RESUME_ROUNDS)
        print(f"{label} resume: launches {got}, losses {res['losses']}, "
              f"restore in the CLI {res['ckpt']['restore_s']} s")
        if label in LM_RELEARN and not res["losses"][0] < losses[0]:
            raise SystemExit(f"{label} resume: round 0's batches again, "
                             f"loss {res['losses'][0]} not below the first "
                             f"run's {losses[0]}")
        if got != want or not all(np.isfinite(res["losses"])):
            raise SystemExit(f"{label} resume: launches {got}, want "
                             f"{want}; losses {res['losses']}")
        for k, v in got.items():
            launches[k] += v
        del res
        torch.cuda.empty_cache()
    return launches


def lm_train(device):
    """Slice 10's path: minicpm-2b x 2 layers on the direct round."""
    return lm_phase("lm_train", device)


def lm_comm(device):
    """Slice 11's comm path: the same minicpm-2b cut, 4 clients on the
    parallel strategy, ``--compressor int8`` (rows 2 and 5)."""
    return lm_phase("lm_comm", device)


def lm_seq(device):
    """Slice 11's sequential path: gemma2-9b x 2 layers at its published
    widths, 2 clients on its arch's sequential strategy, ``--compressor
    int8`` (rows 1 and 4)."""
    return lm_phase("lm_seq", device)


def lm_moe(device):
    """Slice 12's MoE path: deepseek-v2-lite-16b x 2 layers at its
    published widths (MLA attention, MoE with shared experts), 2 clients
    on its arch's sequential strategy, ``--compressor int8`` (rows 1 and
    4)."""
    return lm_phase("lm_moe", device)


def lm_rec(device):
    """Slice 13's RG-LRU path: recurrentgemma-2b x 3 layers at its
    published widths (two RG-LRU blocks and a local attention block), 2
    clients on its arch's parallel strategy, ``--compressor int8`` (rows 2
    and 5)."""
    return lm_phase("lm_rec", device)


def lm_xlstm(device):
    """Slice 13's xLSTM path: xlstm-1.3b x 8 layers at its published
    widths (seven mLSTM blocks and an sLSTM block, no FFN), 2 clients on
    its arch's parallel strategy, ``--compressor int8`` (rows 2 and 5)."""
    return lm_phase("lm_xlstm", device)


def lm_enc(device):
    """Slice 14's encoder path: hubert-xlarge at its full 48 layers and
    published widths on frame embeddings (bidirectional attention; the
    untied token table enters no op and trains on zero grads), 2 clients
    on its arch's parallel strategy, ``--compressor int8`` (rows 2 and
    5)."""
    return lm_phase("lm_enc", device)


def lm_vlm(device):
    """Slice 14's VLM path: qwen2-vl-2b x 2 layers at its published
    widths on patch embeddings (M-RoPE, bf16 SwiGLU), 4 clients on its
    arch's parallel strategy, ``--compressor int8`` (rows 2 and 5)."""
    return lm_phase("lm_vlm", device)


#: the LM's card-against-CPU checks, reduced(d_model=128) at fp32
#: parameters, J=2, tau=2, batch 2, 2 rounds: (arch, strategy, clients,
#: seq, comm[, options]), the options `REC_SMALL` / `XLSTM_SMALL` and
#: ``replace``, config fields replaced; gemma2-9b and recurrentgemma-2b
#: at seq 128, past their reduced window (64); xlstm-1.3b at seq 256, two
#: mLSTM chunks; the MoE archs' routing compared choice by choice
#: (`route_flips`)
LM_SMALL = dict(iters=2, tau=2, batch=2, rounds=2)
#: the recurrent archs' options: ``clip``, a parameter coordinate may
#: move by a flipped Sophia clip within the count (as the MoE archs'
#: may; at m near 0 the scans' order error sets its sign); ``resync``,
#: every round starts the card from a copy of the CPU's state (the
#: sLSTM's input-gate biases leave round 0 a flipped clipped step apart,
#: `slstm_input_gates`, so round 1 would compare two models, not two
#: devices)
REC_SMALL = dict(clip=True)
XLSTM_SMALL = dict(clip=True, resync=True)
BIDIR_LM = dict(compressor="int8", downlink_compressor="int8",
                hessian_compressor="int4", participation=0.5)
LM_SMALL_CASES = {
    "minicpm-2b parallel": ("minicpm-2b", "parallel", 2, 32, {}),
    "gemma2-9b sequential": ("gemma2-9b", "sequential", 2, 128, {}),
    "gemma2-9b sequential int8": ("gemma2-9b", "sequential", 2, 128,
                                  dict(compressor="int8")),
    "qwen3-14b sequential": ("qwen3-14b", "sequential", 2, 32, {}),
    "deepseek-v2-lite-16b sequential": ("deepseek-v2-lite-16b",
                                        "sequential", 2, 32, {}),
    "deepseek-v2-lite-16b parallel": ("deepseek-v2-lite-16b", "parallel",
                                      2, 32, {}),
    "qwen3-moe-235b-a22b sequential": ("qwen3-moe-235b-a22b",
                                       "sequential", 2, 32, {}),
    "minicpm-2b bidir int8/int8/int4 S=2 of 4": ("minicpm-2b", "parallel",
                                                 4, 32, BIDIR_LM),
    "minicpm-2b int8 EF": ("minicpm-2b", "parallel", 4, 32,
                           dict(compressor="int8", error_feedback=True)),
    "minicpm-2b topk": ("minicpm-2b", "parallel", 4, 32,
                        dict(compressor="topk", topk_ratio=TOPK_RATIO)),
    "minicpm-2b signsgd majority": ("minicpm-2b", "parallel", 4, 32,
                                    dict(compressor="signsgd",
                                         sign_majority=True)),
    "recurrentgemma-2b parallel": ("recurrentgemma-2b", "parallel", 2, 128,
                                   {}, REC_SMALL),
    "recurrentgemma-2b parallel, 5 layers": (
        "recurrentgemma-2b", "parallel", 2, 128, {},
        dict(REC_SMALL, replace=dict(num_layers=5))),
    "xlstm-1.3b parallel": ("xlstm-1.3b", "parallel", 2, 256, {},
                            XLSTM_SMALL),
    "xlstm-1.3b parallel, d_ff=0": ("xlstm-1.3b", "parallel", 2, 256, {},
                                    dict(XLSTM_SMALL, replace=dict(d_ff=0))),
    "qwen2-vl-2b parallel": ("qwen2-vl-2b", "parallel", 2, 32, {}),
    "hubert-xlarge parallel int8": ("hubert-xlarge", "parallel", 2, 32,
                                    dict(compressor="int8")),
}


def slstm_input_gates(cfg, spec) -> np.ndarray:
    """The flat coordinates of every sLSTM block's input-gate biases
    (``b_gates[D:2D]``) in the packed layout ``spec``.  Their gradient
    cancels to rounding noise: the stabilizer ``m_t = max(f_t + m_{t-1},
    i_t)`` makes ``exp(i_t - m_t)`` flat in ``i_t`` wherever ``i_t`` is
    the max (every step 0), so Sophia's clip follows the noise's sign
    there, on the CPU and on the card alike."""
    D = cfg.d_model
    return tflat.leaf_coords(spec, "/mixer/b_gates", D, 2 * D).numpy()


def lm_small_launches(fed, rounds, leafy) -> dict:
    """The exact launches of ``rounds`` LM rounds of ``fed`` (parallel:
    one batched launch a stage; sequential: one flat launch a
    participant a stage), from `FedEngine._round_comm` and
    `comm_client_step[_batched]`: J Sophia steps; the uplink's
    round-trip (int8 with EF: the fused uplink; top-k: the threshold;
    SignSGD: the sign round-trip); the downlink's broadcast; the
    hessian stream's round-trip of each participant's h and the
    server's one flat round-trip of the averaged curvature.  ``leafy``:
    whether the steps take the leaf route (`sophia_update.takes_leaves`
    of the resident state)."""
    comm = fed.comm
    S = comm.num_participants(fed.num_clients)
    par = fed.strategy == "parallel"
    n = rounds if par else rounds * S
    form = "batched" if par else "flat"
    want = {("sophia_update_leaves" if leafy else "sophia_update_" + form):
            n * fed.local_iters}

    def add(kernel, count):
        want[kernel] = want.get(kernel, 0) + count
    up = comm.compressor
    if up in ("int8", "int4"):
        add(("uplink" if tcomp.wants_error_feedback(comm) else "quant")
            + f"_roundtrip_{form}", n)
    elif up == "topk":
        add(f"topk_threshold_{form}", n)
    elif up == "signsgd":
        add(f"sign_roundtrip_{form}", n)
    if comm.downlink_compressor == "int8":
        add(f"broadcast_roundtrip_{form}", n)
    if comm.hessian_compressor == "int4":
        add(f"quant_roundtrip_{form}", n)
        add("quant_roundtrip_flat", rounds)
    return expect(**want)


#: a token's first flipped MoE choice between two runs from the same
#: params is a fault above this share of its top probability (the order
#: error of fp32 GEMMs)
FLIP_MARGIN = 1e-5


class RouteRecorder:
    """Records ``(probs, expert_idx)`` of every MoE top-k call of the
    port (`repro_torch.models.layers.top_k`) while entered, on the
    host."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.top_k, self.calls = layers, layers.top_k, []

        def recording(x, k):
            v, i = self.top_k(x, k)
            self.calls.append((x.detach().float().cpu(), i.cpu()))
            return v, i
        layers.top_k = recording
        return self

    def __exit__(self, *exc):
        self.layers.top_k = self.top_k


def route_flips(label, ref, got, exact):
    """The (token, k) choices of ``got``'s calls that differ from
    ``ref``'s (two `RouteRecorder` runs of the same code), each printed
    with its margin, the gap in probability between the two experts.  In
    the first ``exact`` calls (the params of both runs the same) a
    token's first flip above `FLIP_MARGIN` of its top probability is a
    fault.  Returns the number of flipped choices."""
    if len(ref) != len(got):
        raise SystemExit(f"{label}: {len(ref)} top-k calls against "
                         f"{len(got)}")
    count, flipped = 0, set()
    for call, ((p, ri), (_, gi)) in enumerate(zip(ref, got)):
        rows = torch.nonzero(torch.any(torch.sort(ri, -1)[0]
                                       != torch.sort(gi, -1)[0], -1))
        for tok in map(tuple, rows.tolist()):
            a = set(ri[tok].tolist()) - set(gi[tok].tolist())
            b = set(gi[tok].tolist()) - set(ri[tok].tolist())
            top = float(p[tok].max())
            for ea, eb in zip(sorted(a), sorted(b)):
                margin = abs(float(p[tok][ea]) - float(p[tok][eb]))
                first = tok not in flipped
                print(f"{label}: top-k call {call}, token {tok}: expert "
                      f"{ea} on the CPU, {eb} on the card, margin {margin} "
                      f"of top {top}" + ("" if first else " (follows)"))
                count += 1
                if call < exact and first and margin > FLIP_MARGIN * top:
                    raise SystemExit(f"{label}: a flip at margin {margin} "
                                     f"of top {top} is not a near-tie")
            flipped.add(tok)
    return count


@contextlib.contextmanager
def one_cpu_thread():
    """torch's CPU ops on one thread inside: a CPU reference whose sums
    run in one order, the same in every run.  On the thread pool they do
    not: the xlstm small case's CPU state differed from run to run on
    the card's machine, and its round-1 h lay 0.32-1.57 bands from the
    card's, whose own state repeated (ROADMAP queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def lm_small_case(device, label):
    """One `LM_SMALL_CASES` run, card against CPU (the CPU's rounds on one
    thread, `one_cpu_thread`): the same weights,
    batches, GNB noise and comm draws; losses within rtol 1e-4 / atol
    1e-5, every resident buffer within that band but for at most
    `SMALL_MAX_FLIPS` coordinates a buffer, each within one move of its
    streams (`ScaleProbe`: a quant step, a threshold, twice a SignSGD
    scale; none on a lossless round).  Returns the card's launches,
    asserted exactly (`lm_small_launches`).  Every coordinate outside
    the band is printed with its leaf (`print_flips`).  MoE archs:
    every top-k call's choices compared (`route_flips`; the first
    forward of round 0 starts from the same params), and a parameter
    coordinate may also move by a flipped Sophia clip (at m near 0,
    where the GEMMs' order error sets the sign: ``2 lr J / C`` a
    round), within the same count; so may the recurrent archs' (the
    ``clip`` option).  xlstm: the sLSTM's input-gate biases may move by
    that clip outside the count, their m and h not held
    (`slstm_input_gates`), and each round starts from the CPU's state
    (the ``resync`` option)."""
    from repro_torch.configs import get_model_config
    from repro_torch.models.transformer import LMTask
    arch, strategy, C, seq, comm_kw, *opts = LM_SMALL_CASES[label]
    opts = opts[0] if opts else {}
    sm = LM_SMALL
    cfg = dataclasses.replace(get_model_config(arch).reduced(d_model=128),
                              dtype="float32", **opts.get("replace", {}))
    task = LMTask(cfg)
    fed = FedConfig(num_clients=C, local_iters=sm["iters"], tau=sm["tau"],
                    lr=1e-3, schedule="wsd", total_rounds=sm["rounds"],
                    strategy=strategy, comm=CommConfig(**comm_kw))
    params = task.init(gen("cpu", SEED + 11), "cpu")
    engines = {key: FedEngine(task, fed, device=dev)
               for key, dev in (("cpu", "cpu"), ("card", device))}
    states = {key: e.pack_state(e.init_from_params(
        {k: v.to(e.device) for k, v in params.items()}))
        for key, e in engines.items()}
    flips, launches, route = [], {}, []
    moe = cfg.moe is not None
    spec = engines["cpu"].runtime_for(states["cpu"]["params"]).spec
    free = slstm_input_gates(cfg, spec)
    for r in range(sm["rounds"]):
        if r and opts.get("resync"):
            states["card"] = convert.state_from_numpy(
                convert.state_to_numpy(states["cpu"]), device=device)
        b = lm_batches(cfg, gen("cpu", SEED + 20 + r), C, sm["batch"], seq,
                       "cpu")
        g = gumbel_noise(gen("cpu", SEED + 30 + r),
                         (C, sm["iters"], sm["batch"], seq,
                          cfg.vocab_padded))
        cnoise = (None if engines["cpu"].uses_direct_path() else
                  small_comm_noise(engines["cpu"], states["cpu"], r,
                                   {"clients": C}))
        losses, steps, calls = {}, {}, {}
        for key, engine in engines.items():
            dev = engine.device
            reset_launches()
            with ScaleProbe(fed.comm) as probe, RouteRecorder() as rec, (
                    one_cpu_thread() if key == "cpu"
                    else contextlib.nullcontext()):
                states[key], m = engine.round(
                    states[key], {k: v.to(dev) for k, v in b.items()},
                    gumbel=g.to(dev), comm_noise=cnoise)
            calls[key] = rec.calls
            losses[key] = float(m["loss"])
            if key == "card":
                for k, v in launch_counts().items():
                    launches[k] = launches.get(k, 0) + v
            for k, v in probe.steps.items():
                steps[k] = max(steps.get(k, 0.0), v)
        np.testing.assert_allclose(
            losses["card"], losses["cpu"], rtol=SMALL_RTOL, atol=SMALL_ATOL,
            err_msg=f"lm small check {label} round {r}: loss")
        if moe:
            route.append(route_flips(
                f"lm small check {label} round {r}", calls["cpu"],
                calls["card"], cfg.num_layers if r == 0 else 0))
        if moe or opts.get("clip"):
            steps["clip"] = 2 * fed.lr * sm["iters"] * (r + 1) / C
        want_b, got_b = (state_buffers(states[k]) for k in ("cpu", "card"))
        print_flips(f"lm small check {label} round {r}", spec, want_b,
                    got_b)
        flips.append(flip_band(f"lm small check {label} round {r}",
                               want_b, got_b, steps, free))
    card = states["card"]
    want = lm_small_launches(fed, sm["rounds"], tk.takes_leaves(
        card["params"], card["client_opt"].m, card["client_opt"].h))
    if launches != want:
        raise SystemExit(f"lm small check {label}: launches {launches}, "
                         f"want {want}")
    print(f"lm small check ({label}, reduced, fp32, card vs CPU): card "
          f"agrees within rtol {SMALL_RTOL} / atol {SMALL_ATOL} but for "
          f"coordinates one move off (per buffer, rounds 1-2: {flips}); "
          f"launches {({k: v for k, v in launches.items() if v})}"
          + (f"; flipped MoE choices per round {route}" if moe else ""))
    return launches


#: `remat_check`'s archs (a dense one and the MoE one) and its batch,
#: sequence and width (reduced, 2 layers)
REMAT_CHECK_ARCHS = ("minicpm-2b", "deepseek-v2-lite-16b")
REMAT_CHECK_SHAPE = (2, 64, 128)


def remat_check(device):
    """Remat's recompute on the card against its forward: for each arch
    of `REMAT_CHECK_ARCHS`, at fp32 and at the arch's own dtype, the
    loss, its grads and the GNB estimate with ``train_remat`` True equal
    bitwise those with it False, from the same params, batch and noise.
    A MoE route that flipped between the forward and the recompute would
    change the grads and no shape, so checkpoint's own check of the
    recomputed tensors' metadata would pass it."""
    from repro_torch.configs import get_model_config
    from repro_torch.core.gnb import gnb_estimate, leaf_grads
    from repro_torch.models.transformer import LMTask
    B, S, d = REMAT_CHECK_SHAPE
    for arch in REMAT_CHECK_ARCHS:
        base = get_model_config(arch).reduced(d_model=d)
        for dtype in dict.fromkeys(("float32", base.dtype)):
            outs = {}
            for remat in (True, False):
                cfg = dataclasses.replace(base, dtype=dtype,
                                          train_remat=remat)
                task = LMTask(cfg)
                params = {k: v.to(device) for k, v in task.init(
                    gen("cpu", SEED + 41), "cpu").items()}
                batch = {k: v[0].to(device) for k, v in
                         syn.make_token_batch(gen("cpu", SEED + 42), 1, B,
                                              S, cfg.vocab_size).items()}
                noise = gumbel_noise(gen("cpu", SEED + 43),
                                     (B, S, cfg.vocab_padded), device)
                pg = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
                loss = task.loss(pg, batch)
                grads = leaf_grads(loss.sum(), list(pg.values()))
                h = gnb_estimate(task, params, batch, noise)
                outs[remat] = ([loss.detach()] + grads
                               + [h[k] for k in sorted(h)])
            differ = [i for i, (a, b) in enumerate(zip(outs[True],
                                                       outs[False]))
                      if a.dtype != b.dtype or not torch.equal(a, b)]
            if differ or len(outs[True]) != len(outs[False]):
                raise SystemExit(f"remat check {arch} {dtype}: remat on and "
                                 f"off differ in outputs {differ} (loss, "
                                 f"grads, GNB)")
            print(f"remat check ({arch}, reduced, {dtype}, B={B} S={S}): "
                  f"loss, {len(grads)} grads and the GNB estimate with "
                  f"remat equal bitwise those without")


def print_flips(label, spec, want, got, most=8) -> None:
    """Prints the leaf, index, CPU and card values of the first ``most``
    coordinates of the params, m and h outside the small band (m and h:
    client by client)."""
    starts = np.cumsum((0,) + spec.sizes)
    for name in ("params", "m", "h"):
        rows = want[name].reshape(-1, spec.rows * spec.cols)
        for k, (w, g) in enumerate(zip(
                rows, got[name].reshape(rows.shape))):
            out = np.flatnonzero(np.abs(g - w)
                                 > SMALL_ATOL + SMALL_RTOL * np.abs(w))
            for c in out[:most]:
                i = int(np.searchsorted(starts, c, side="right")) - 1
                leaf = spec.keys[i] if i < len(spec.keys) else "pad"
                print(f"{label}: {name}[{k}] coordinate {c} "
                      f"({leaf}[{c - starts[i]}]): CPU {w[c]}, card {g[c]}")


def lm_small_check(device):
    """`remat_check`, then every `LM_SMALL_CASES` run (`lm_small_case`);
    returns the card's launch counts summed over the runs."""
    remat_check(device)
    total = {name: 0 for name in REPLACES}
    for label in LM_SMALL_CASES:
        for k, v in lm_small_case(device, label).items():
            total[k] += v
    return total


#: slice 14's serving path (`lm_serve`): the serve CLI's twin
#: (`repro_torch.launch.serve.main`) at the full published depth and
#: widths, bf16, random weights from the seed: arch -> (batch, prompt,
#: gen).  qwen2-vl-2b (28 layers) on patch embeddings with M-RoPE, each
#: sampled token's embed row fed back; gemma2-9b (42 layers) with a
#: prompt past its 4096 window, so the local layers' rolling buffer is
#: regrouped and then wrapped
SERVE_PHASES = {"qwen2-vl-2b": (8, 512, 64), "gemma2-9b": (2, 4352, 32)}


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def reckon_serve_peak(cfg, batch, prompt, gen):
    """The peak of a serve run and its decode-against-forward check,
    reckoned by buffer before the run: ``(name, bytes)`` pairs.  What is
    allocated already (the cuBLAS workspaces, read from the allocator);
    the weights; the prefill's caches (every attention layer holds the
    prompt's positions until `prefill_to_decode_cache` regroups them);
    three fp32 ``(B, P + 1, Vp)`` logits (the check's forward over the
    prompt and a token: the widened logits, the softcap's quotient and
    its tanh, or its product); the last hidden state and its norm
    (bf16); the sampled steps' logits (fp32)."""
    from repro_torch.models import transformer as T
    weights = nbytes(T.init_lm(T._ShapeOnly(), cfg).values())
    caches = nbytes(T.init_cache(dataclasses.replace(cfg, window=None),
                                 batch, prompt, device="meta").values())
    tokens = batch * (prompt + 1)
    return [("allocated before the run", torch.cuda.memory_allocated()),
            ("weights (bf16)", weights),
            ("the prefill's caches", caches),
            ("three fp32 logits over the prompt and a token",
             3 * 4 * tokens * cfg.vocab_padded),
            ("the last hidden state and its norm (bf16)",
             2 * 2 * tokens * cfg.d_model),
            ("the sampled steps' logits (fp32)",
             4 * gen * batch * cfg.vocab_padded)]


def serve_check_band(cfg) -> float:
    """The decode-against-forward gate of a bf16 model, as a share of the
    logits' largest magnitude (above 1): the tests' bf16 logits band of a
    2-layer model (2^-6: two bf16 steps), grown as the square root of
    the depth over 2 (each layer's GEMMs round their bf16 outputs at
    other points when M is one token and when it is the sequence, and
    the layers' rounding errors add as a random walk)."""
    return 2 ** -6 * float(np.sqrt(cfg.num_layers / 2))


def lm_serve(device):
    """Slice 14's serving path: `SERVE_PHASES` through ``repro_torch.
    launch.serve.main`` with ``--obs-log``.  Gates: no kernel of the
    table launched (the serving path has none: the JAX package's reaches
    no Pallas kernel); finite logits; the ``serve`` record valid under
    the schema; the peak at or under its reckoning (`reckon_serve_peak`,
    printed before the run); the first decode step's logits (position P,
    from the rolling and padded caches) against the full forward's at
    position P over the prompt and the first sampled token, within
    `serve_check_band`.  Prints prefill seconds, the decode steps' p50 /
    p95 ms, tokens/s and the peak (host clock after a synchronise; the
    card's name and power limit beside), then profiles one decode step
    on an empty cache of the same shapes (busy share of the p50 step,
    device time by class).  Returns the launch counts (all 0)."""
    import tempfile
    from repro_torch import obs
    from repro_torch.configs import get_model_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    card = card_info()
    for arch, (B, P, G) in SERVE_PHASES.items():
        cfg = get_model_config(arch)
        torch.cuda.empty_cache()
        parts = reckon_serve_peak(cfg, B, P, G)
        reckoned = sum(b for _, b in parts)
        print(f"lm_serve {arch}: reckoned peak {reckoned} bytes: "
              + "; ".join(f"{name} {b}" for name, b in parts))
        with tempfile.TemporaryDirectory(prefix="lm_serve_") as tmp:
            log = str(Path(tmp) / "serve.jsonl")
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            res = serve.main(["--arch", arch, "--batch", str(B),
                              "--prompt-len", str(P), "--gen", str(G),
                              "--seed", str(SEED), "--obs-log", log])
            got = launch_counts()
            if got != expect():
                raise SystemExit(f"lm_serve {arch}: launches {got}")
            recs = obs.read_records(log)
            for rec in recs:
                obs.validate_record(rec)
        params, prompt = res["params"], res["prompt"]
        if (res["tokens"].shape != (B, G)
                or not all(torch.isfinite(lg).all() for lg in res["logits"])):
            raise SystemExit(f"lm_serve {arch}: tokens "
                             f"{tuple(res['tokens'].shape)}, logits not "
                             "finite")
        # the check: the prompt and the first sampled token, whole
        tok0 = res["tokens"][:, :1]
        if cfg.embedding_inputs:
            full = {"embeds": torch.cat([prompt["embeds"],
                                         params["embed"][tok0]], dim=1)}
        else:
            full = {"tokens": torch.cat([prompt["tokens"], tok0], dim=1)}
        with torch.no_grad():
            ref = T.forward(params, cfg, full, remat=False)[0][:, P]
        sync()
        peak = torch.cuda.max_memory_allocated()
        dec = res["logits"][1]
        diff = float((dec - ref).abs().max())
        top = max(1.0, float(ref.abs().max()))
        agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"lm_serve {arch}: decode logits at position {P} against the "
              f"full forward's over {P + 1} positions: largest difference "
              f"{diff} (of the largest logit {top}: {diff / top}; gate "
              f"{serve_check_band(cfg)}), top-1 agreement {agree}")
        if diff > serve_check_band(cfg) * top:
            raise SystemExit(f"lm_serve {arch}: decode against forward "
                             f"{diff} past the band")
        rec = [r for r in recs if r["record"] == "serve"][0]
        q = sorted(res["step_ms"])
        print(f"lm_serve {arch} x {cfg.num_layers} layers, bf16, batch {B}, "
              f"prompt {P}, gen {G}: prefill {res['prefill_s']} s, decode "
              f"p50 {rec['decode_p50_ms']} ms, p95 {rec['decode_p95_ms']} "
              f"ms (min {q[0]}, max {q[-1]}), {res['tokens_per_s']} tok/s; "
              f"peak device memory {peak} bytes against the reckoned "
              f"{reckoned} ({(reckoned - peak) / 1e9} GB under); {card}")
        if peak > reckoned:
            raise SystemExit(f"lm_serve {arch}: peak {peak} above the "
                             f"reckoned {reckoned}")
        del res, full, ref, dec
        cache = T.init_cache(cfg, B, P + G, device=device)
        step = ({"embeds": params["embed"][tok0]} if cfg.embedding_inputs
                else {"tokens": tok0})

        def run():
            with torch.no_grad():
                T.decode_step(params, cfg, step, cache, P)
        run()
        print(f"lm_serve {arch}: one profiled decode step (an empty cache "
              f"of the run's shapes, position {P}); {card}")
        profile_call(run, rec["decode_p50_ms"] / 1e3, top=8)
        del params, prompt, cache, step
        torch.cuda.empty_cache()
    return expect()


#: slice 14's card-against-CPU serving checks: reduced(d_model=128) at
#: fp32, batch 2, a prompt of 96 (past the reduced window, 64), 8 tokens
#: teacher-forced (the CPU's samples fed to both), one a cache kind
SERVE_SMALL = dict(batch=2, prompt=96, gen=8)
SERVE_SMALL_CASES = {"GQA, qk-norm": "qwen3-14b",
                     "local / global, both softcaps": "gemma2-9b",
                     "MLA + MoE": "deepseek-v2-lite-16b",
                     "RG-LRU": "recurrentgemma-2b",
                     "mLSTM + sLSTM": "xlstm-1.3b",
                     "M-RoPE, embeds": "qwen2-vl-2b"}


def small_band(label, got, want):
    """Card against CPU: within ``rtol`` `SMALL_RTOL` and ``atol``
    `SMALL_ATOL` times the larger of 1 and the largest magnitude (an
    mLSTM's matrix memory reaches 10^2)."""
    want = want.cpu().float().numpy()
    top = max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(got.cpu().float().numpy(), want,
                               rtol=SMALL_RTOL, atol=SMALL_ATOL * top,
                               err_msg=label)


def serve_small_check(device):
    """Each `SERVE_SMALL_CASES` arch served on the CPU (prefill, then
    decode steps sampling with seeded gumbel noise) and on the card from
    the same weights and prompt, the CPU's tokens fed to both: the
    prefill's and every step's logits, and every cache leaf after the
    prefill and after the last step (the recurrent states included), in
    `small_band`.  No kernel of the table launches (asserted).  Returns
    the launch counts."""
    from repro_torch.configs import get_model_config
    from repro_torch.models import transformer as T
    B, P, G = (SERVE_SMALL[k] for k in ("batch", "prompt", "gen"))
    for label, arch in SERVE_SMALL_CASES.items():
        cfg = dataclasses.replace(get_model_config(arch).reduced(d_model=128),
                                  dtype="float32")
        params = T.init_lm(gen("cpu", SEED + 50), cfg)
        g = gen("cpu", SEED + 51)
        prompt = ({"embeds": torch.randn(B, P, cfg.d_model, generator=g)}
                  if cfg.embedding_inputs else
                  {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                           generator=g)})
        runs = {}
        tokens = []
        reset_launches()
        for key, dev in (("cpu", torch.device("cpu")), ("card", device)):
            p = {k: v.to(dev) for k, v in params.items()}
            logits, caches = [], []
            with torch.no_grad():
                lg, cache, _ = T.forward(p, cfg, {k: v.to(dev) for k, v in
                                                  prompt.items()},
                                         want_cache=True, remat=False)
                logits.append(lg[:, -1].cpu())
                # copies: decode writes the recurrent states in place
                caches.append({k: v.to("cpu", copy=True)
                               for k, v in cache.items()})
                cache = T.prefill_to_decode_cache(cfg, cache, P, P + G)
                for i in range(G):
                    if key == "cpu":
                        tokens.append(T.sample_labels(
                            logits[-1], cfg.vocab_size,
                            gumbel_noise(gen("cpu", SEED + 60 + i),
                                         logits[-1].shape)))
                    tok = tokens[i].to(dev)
                    step = ({"embeds": p["embed"][tok][:, None]}
                            if cfg.embedding_inputs
                            else {"tokens": tok[:, None]})
                    lg, cache = T.decode_step(p, cfg, step, cache, P + i)
                    logits.append(lg[:, -1].cpu())
                caches.append({k: v.cpu() for k, v in cache.items()})
            runs[key] = (logits, caches)
        if launch_counts() != expect():
            raise SystemExit(f"serve small check {label}: launches "
                             f"{launch_counts()}")
        (want_l, want_c), (got_l, got_c) = runs["cpu"], runs["card"]
        for i, (gl, wl) in enumerate(zip(got_l, want_l)):
            small_band(f"serve small check {label}: logits {i}", gl, wl)
        for stage, gc, wc in zip(("prefill", "last step"), got_c, want_c):
            for k, v in wc.items():
                small_band(f"serve small check {label}: {stage} {k}",
                           gc[k], v)
        print(f"serve small check ({label}, {arch} reduced, fp32, card vs "
              f"CPU, prompt {P}, {G} tokens teacher-forced): logits and "
              f"the {len(want_c[1])} cache leaves within rtol {SMALL_RTOL} "
              f"/ atol {SMALL_ATOL} of the largest magnitude")
    return expect()


#: the LM entries' timing: fewer launches (each is milliseconds), the
#: plain versions queued a few at a time
LM_TIMED_LAUNCHES, LM_PLAIN_CHUNK = 50, 5


def lm_leaf_inputs(arch, layers, lead, device, seed):
    """The leaf-boundary step's operands at an LM slice's real size,
    drawn on the card: the layout of ``arch`` x ``layers``' parameters
    (`init_lm`'s shapes and dtypes), fp32 theta, m, h of `sophia_inputs`'
    distributions over ``lead`` clients, the grads and h_hat leaves in
    each leaf's dtype (a tied embedding's stored with its last two axes
    swapped, as its head's GEMM returns it), the params store of the
    leaves not stored fp32, and the zero h_hat buffer."""
    from repro_torch.configs import get_model_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_model_config(arch), num_layers=layers)
    tree = T.init_lm(T._ShapeOnly(), cfg)
    spec = tflat.flat_spec(tree, cols=1024)
    g = gen(device, seed)
    shape = lead + (spec.rows, spec.cols)
    th = torch.randn(shape, generator=g, device=device)
    m = torch.randn(shape, generator=g, device=device).mul_(0.1)
    h = torch.randn(shape, generator=g, device=device).mul_(0.01).abs_()
    h.view(-1)[::17] = 0.0

    def leaves(scale, positive):
        out = {}
        for k in spec.keys:
            shp = lead + tuple(tree[k].shape)
            swap = k == "embed" and cfg.tie_embeddings
            x = torch.randn(shp[:-2] + shp[:-3:-1] if swap else shp,
                            generator=g, device=device).mul_(scale)
            x = (x.abs_() if positive else x).to(tree[k].dtype)
            out[k] = x.transpose(-1, -2) if swap else x
        return out
    grads, h_hat = leaves(0.5, False), leaves(0.02, True)
    out = {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype,
                          device=device)
           for k, v in tree.items() if v.dtype != torch.float32}
    return spec, th, m, h, grads, h_hat, out, torch.zeros_like(th)


def lm_leaf_same_bits(label, spec, before, after, grads, h_hat, out,
                      chunk=1 << 24):
    """`same_bits` of a leaf-boundary refresh step's theta, m, h
    (``after``) and params store against `kref.sophia_update_leaves_ref`
    run from ``before`` one leaf at a time, in runs of at most ``chunk``
    coordinates a client: the check holds no full-size temporaries of
    the plain version."""
    lead = tuple(before[0].shape[:-2])
    flat = [[x.reshape(lead + (spec.padded,)) for x in xs]
            for xs in (before, after)]
    worst, off = 0.0, 0
    for k, sz, dt in zip(spec.keys, spec.sizes, spec.dtypes):
        g_k, hh_k = (src[k].reshape(lead + (sz,)) for src in (grads, h_hat))
        o_k = out[k].view(lead + (sz,)) if k in out else None
        for a in range(0, sz, chunk):
            n = min(chunk, sz - a)
            sub = tflat.FlatSpec((k,), (n,), ((n,),), (dt,), n, 1, n)
            run = slice(off + a, off + a + n)
            want = kref.sophia_update_leaves_ref(
                *(x[..., run].reshape(lead + (1, n)) for x in flat[0]),
                {k: g_k[..., a:a + n]}, {k: hh_k[..., a:a + n]}, 1.0,
                spec=sub, out_dtypes={k: dt} if o_k is not None else {},
                lr=LR, **HP)
            got = tuple(x[..., run].reshape(lead + (1, n)) for x in flat[1])
            if o_k is not None:
                got, want = (got + (o_k[..., a:a + n],),
                             tuple(want[:3]) + (want[3][k],))
            worst = max(worst, same_bits(f"{label} {k}",
                                         "sophia_update_leaves", got,
                                         tuple(want[:len(got)])))
            del want
        off += sz
    return worst


def lm_same_bits(label, name, got, plain, ins, chunks=8):
    """`same_bits` of a kernel's outputs ``got`` against ``plain`` run
    on row slices of ``ins`` (an elementwise function: the slices of
    its full-size result), so the check holds no second full-size
    result and no full-size compare temporaries."""
    got = got if isinstance(got, tuple) else (got,)
    R = got[0].shape[-2]
    step = -(-R // chunks)
    worst = 0.0
    for lo in range(0, R, step):
        sl = slice(lo, min(lo + step, R))
        want = plain([x[..., sl, :] if torch.is_tensor(x) and x.ndim >= 2
                      else x for x in ins])
        worst = max(worst, same_bits(label, name,
                                     tuple(g[..., sl, :] for g in got),
                                     want))
        del want
    return worst


def time_lm_kernels(device):
    """The kernels at the LM slices' shapes, each bitwise its plain
    version and timed (`time_pair`):

    * the leaf-boundary form (the leaf route, `sophia_update_leaves`) at
      each LM phase's step: minicpm-2b x 2 layers over its 4 clients
      ``(4, 395724, 1024)``, recurrentgemma-2b x 3 and xlstm-1.3b x 8
      over 2 ``(2, 890933, 1024)``, ``(2, 755049, 1024)``, gemma2-9b x 2
      and deepseek-v2-lite-16b x 2 one client ``(1283104, 1024)``,
      ``(1551883, 1024)``: bf16 leaves (a tied embedding's grads
      swapped), the params store.  A refresh step checked against
      `kref.sophia_update_leaves_ref` a leaf at a time
      (`lm_leaf_same_bits`); a plain step (the zero h_hat buffer) timed
      against the packed route it replaced (pack the grads, row 1 or 2,
      unpack theta), whose plain version's temporaries exceed the card;
    * row 4 at gemma2-9b's and deepseek-v2-lite-16b's slices: x and the
      noise read, x̂ written (and the row scales), 12 B a coordinate;
    * row 5 at each int8 parallel phase's cohort: minicpm-2b's 4
      clients ``(4, 395724, 1024)``, recurrentgemma-2b's and xlstm-1.3b's
      2: 12 B a coordinate.

    Returns (name, LM slice) -> timing."""
    lr = torch.tensor(LR)
    out = {}
    card = card_info()
    layers = {arch: n for arch, n, *_ in LM_PHASES.values()}

    def report(key, arch, t, err):
        print(f"lm slice {key} ({arch}): {t['ms']} ms against a "
              f"{t['bound_ms']} ms bound ({t['bound_ms'] / t['ms']} of it), "
              f"plain {t['plain_ms']} ms, max |err| {err}; {card}")
        out[key, arch] = t

    name = "sophia_update_leaves"
    for arch, lead, packed in (
            (LM_ARCH, (LM_CLIENTS,), LM_PACKED),
            (REC_ARCH, (REC_CLIENTS,), REC_PACKED),
            (XLSTM_ARCH, (REC_CLIENTS,), XLSTM_PACKED),
            (SEQ_ARCH, (), SEQ_PACKED), (MOE_ARCH, (), MOE_PACKED)):
        spec, th, m, h, g, hh, store, zero = lm_leaf_inputs(
            arch, layers[arch], lead, device, SEED + 98)
        if (spec.rows, spec.cols) != packed:
            raise SystemExit(f"lm slice {arch}: the layout packs "
                             f"{(spec.rows, spec.cols)}, not {packed}")
        before = [x.clone() for x in (th, m, h)]
        steps, vec = tk.STEPS[name], tk.F32X4_LAUNCHES[name]
        tk.sophia_update_leaves(th, m, h, g, hh, 1, LR, spec=spec,
                                out=store, **HP)
        sync()
        if tk.STEPS[name] != steps + 1:
            raise SystemExit(f"lm slice {arch}: the leaf-boundary form "
                             "did not launch")
        err = lm_leaf_same_bits(f"lm slice {arch}", spec, before,
                                (th, m, h), g, hh, store)
        print(f"lm slice {name} ({arch}): refresh step with the params "
              f"store bitwise the plain version; every leaf vector "
              f"accesses: {tk.F32X4_LAUNCHES[name] != vec}")
        del before, hh
        torch.cuda.empty_cache()
        step = tk.sophia_update_batched if lead else tk.sophia_update_flat

        def packed_route(i):
            step(th, m, h, tflat.pack(g, spec), zero, 0, lr, inplace=True,
                 **HP)
            tflat.unpack(th, spec)
        report(name, arch, time_pair(
            f"{name} (LM slice: {arch} x {layers[arch]} layers"
            + (f", {lead[0]} clients" if lead else "") + ")",
            lambda i: tk.sophia_update_leaves(th, m, h, g, zero, 0, LR,
                                              spec=spec, out=store, **HP),
            packed_route, [th, m, h, *g.values(), zero],
            [th, m, h, *store.values()], SOPHIA_OPS,
            # a call's host work grows with the leaves (xlstm-1.3b x 8 has
            # 113): the packed route's pack and unpack, about 20 ms a
            # call on the card's host, are queued one call at a time,
            # each behind its own sleep, so fewer calls are timed
            plain_chunk=1, kernel_chunk=2, launches=20), err)
        del spec, th, m, h, g, store, zero
        torch.cuda.empty_cache()

    for name, arch, shape in (
            ("quant_roundtrip_flat", SEQ_ARCH, SEQ_PACKED),
            ("quant_roundtrip_flat", MOE_ARCH, MOE_PACKED),
            ("quant_roundtrip_batched", LM_ARCH,
             (LM_CLIENTS,) + LM_PACKED),
            ("quant_roundtrip_batched", REC_ARCH,
             (REC_CLIENTS,) + REC_PACKED),
            ("quant_roundtrip_batched", XLSTM_ARCH,
             (REC_CLIENTS,) + XLSTM_PACKED)):
        g = gen(device, SEED + 96)
        x = torch.randn(shape, generator=g, device=device) * 1e-3
        noise = torch.rand(shape, generator=g, device=device)
        scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127
        entry = getattr(tq, name)
        ins = (x, noise, scale)
        err = lm_same_bits(
            "lm slice", name, entry(x, noise, scale, qmax=127),
            lambda a: kref.quant_roundtrip_ref(*a, qmax=127), ins)
        report(name, arch, time_pair(
            f"{name} (LM slice: {arch} x {layers[arch]} layers"
            + ("" if name.endswith("flat") else f", {shape[0]} clients")
            + ")",
            lambda i: entry(x, noise, scale, qmax=127),
            lambda i: kref.quant_roundtrip_ref(x, noise, scale, qmax=127),
            ins, [x], QUANT_OPS["quant"], plain_chunk=LM_PLAIN_CHUNK,
            launches=LM_TIMED_LAUNCHES), err)
        del x, noise, scale, ins
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------ cost tools (slice 15)
#: the LM phases whose round `dry_check` traces and holds to what the
#: card measured
DRY_PHASES = ("lm_train", "lm_seq", "lm_moe", "lm_rec", "lm_vlm")
#: the traced peak within this share of the measured peak, either way
DRY_PEAK_BAND = 0.10
#: the dry runs at the published widths (tests/test_dryrun_small.py's
#: five combos), two local iterations: (arch, shape, model config
#: overrides).  A trace costs host time a layer and runs the same code
#: at every depth, so the deep ones are cut: minicpm-2b's train_4k
#: round traced in 51 s at its 40 layers, gemma2-9b's prefill_32k in
#: 24 s at 42, qwen3-moe-235b-a22b's round in 1,063 s at 94 (about 11 s
#: a layer on one CPU core) and 66 s at 4
DRY_COMBOS = (("minicpm-2b", "train_4k", {"num_layers": 8}),
              ("qwen3-moe-235b-a22b", "train_4k", {"num_layers": 2}),
              ("gemma2-9b", "prefill_32k", {"num_layers": 8}),
              ("deepseek-v2-lite-16b", "decode_32k", None),
              ("xlstm-1.3b", "long_500k", None))
DRY_LOCAL_ITERS = 2
#: the serving example's archs on the card
SERVE_EXAMPLE_ARCHS = ("chatglm3-6b", "xlstm-1.3b")


def dry_check(device):
    """Slice 15's cost tools on the card.  (a) Each phase of
    `DRY_PHASES`: one round of the same CLI run traced shape-only
    (`repro_torch.launch.api.build_train_cli`, `dryrun.trace`); its
    launches of each kernel, times the run's rounds, must equal the
    counted launches, and its peak must lie within `DRY_PEAK_BAND` of
    ``torch.cuda.max_memory_allocated``; printed beside the reckoned
    peak, with the roofline time (each op's larger term at the card's
    peaks, summed) over the profiled round's device time.  (b) The dry
    runs of `DRY_COMBOS` (published widths, the deep ones cut) end
    ``ok``, one line each, with ``fits`` against the card's memory."""
    from repro_torch.launch import api, dryrun
    card = card_info()
    cap = torch.cuda.get_device_properties(0).total_memory
    print(f"dry_check: the card's total_memory {cap} bytes; {card}")
    for label in DRY_PHASES:
        m = LM_MEASURED[label]
        t0 = time.perf_counter()
        s = dryrun.trace(api.build_train_cli(m["argv"])).summary()
        trace_s = time.perf_counter() - t0
        traced = {k: v * LM_ROUNDS for k, v in s["launches"].items()}
        print(f"dry_check {label}: traced in {trace_s} s; launches of "
              f"{LM_ROUNDS} rounds traced {traced}, counted "
              f"{m['launches']}")
        if traced != m["launches"]:
            raise SystemExit(f"dry_check {label}: traced launches {traced}, "
                             f"counted {m['launches']}")
        share = s["peak_bytes"] / m["peak"]
        print(f"dry_check {label}: peak traced {s['peak_bytes']} bytes, "
              f"measured {m['peak']} ({share} of it), reckoned "
              f"{m['reckoned']} (reckon_*_peak); roofline {s['roofline_s']} "
              f"s over the profiled round's device time "
              f"{m['device_us'] / 1e6} s: "
              f"{s['roofline_s'] / (m['device_us'] / 1e6)}; traced flops "
              f"{s['flops_by_dtype']}, bytes {s['bytes']}; {card}")
        if abs(share - 1.0) > DRY_PEAK_BAND:
            raise SystemExit(f"dry_check {label}: traced peak "
                             f"{s['peak_bytes']} is {share} of the measured "
                             f"{m['peak']}")
    t_all = time.perf_counter()
    for arch, shape, over in DRY_COMBOS:
        rec = dryrun.run_one(arch, shape, local_iters=DRY_LOCAL_ITERS,
                             out_dir="", cfg_overrides=over)
        print(f"dry_check {dryrun.line_of(rec)} overrides {over}; peak_bytes "
              f"{rec.get('peak_bytes')} of {cap}; roofline "
              f"{rec.get('roofline')}; roofline_s {rec.get('roofline_s')}; "
              f"launches {rec.get('launches')}")
        if rec["status"] != "ok":
            raise SystemExit(f"dry_check: {arch} x {shape}: "
                             f"{rec.get('error')}\n{rec.get('traceback')}")
    print(f"dry_check: dry runs of DRY_COMBOS {time.perf_counter() - t_all} s")


def traced_launches(bundle) -> dict:
    """Each kernel's launches in a shape-only trace of ``bundle``."""
    from repro_torch.launch import dryrun
    return dryrun.trace(bundle).summary()["launches"]


#: the cell of Table I's twin (``hyperparam_table``) that `examples_check`
#: runs, ``(lr, J)``, and its rounds
HYPERPARAM_CELL, HYPERPARAM_ROUNDS = (0.001, 5), 3


def examples_check(device):
    """The four example twins on the card: ``fed_llm_train`` at its
    defaults (the ~100M LM, 100 rounds) and ``comm_compression`` (four
    regimes of 12 rounds), each run's launches of every kernel of the
    table against a shape-only trace of the same rounds; ``serve_batched``
    for `SERVE_EXAMPLE_ARCHS`, which launches none; ``hyperparam_table``
    at `HYPERPARAM_CELL` for `HYPERPARAM_ROUNDS` rounds, one row-2 launch
    a local step.  Returns the launch counts summed over the runs."""
    import tempfile
    from repro_torch.examples import comm_compression, fed_llm_train
    from repro_torch.examples import hyperparam_table, serve_batched
    from repro_torch.launch import api
    card = card_info()
    launches = {name: 0 for name in REPLACES}

    def check(label, got, want):
        print(f"examples_check {label}: launches {got}, want {want}")
        if got != want:
            raise SystemExit(f"examples_check {label}: launches {got}, "
                             f"want {want}")
        for k, v in got.items():
            launches[k] += v

    with tempfile.TemporaryDirectory(prefix="fed_llm_") as tmp:
        argv = ["--ckpt", str(Path(tmp) / "ckpt")]
        reset_launches()
        t0 = time.perf_counter()
        res = fed_llm_train.main(argv)
        sync()
        wall = time.perf_counter() - t0
        got = launch_counts()
    args = fed_llm_train.parse(argv)
    engine = fed_llm_train.build_engine(args, api.TRACE_DEVICE)
    per_round = traced_launches(api.round_bundle(
        engine, (args.clients, args.batch), args.seq, False, {}))
    check("fed_llm_train", got,
          {k: v * args.rounds for k, v in per_round.items()})
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"examples_check fed_llm_train: losses {losses}")
    print(f"examples_check fed_llm_train: {args.rounds} rounds in {wall} s "
          f"(host clock after a synchronise), loss {losses[0]} -> "
          f"{losses[-1]}; {card}")
    del res

    reset_launches()
    res = comm_compression.main([])
    got = launch_counts()
    want = {name: 0 for name in REPLACES}
    batch = comm_compression.make_batches(
        "cpu", comm_compression.make_data("cpu"), 0)
    shapes = {k: (v.shape, v.dtype) for k, v in batch.items()}
    for name, comm in comm_compression.REGIMES.items():
        engine = FedEngine(MLPTask(hidden=comm_compression.HIDDEN),
                           comm_compression.fed_config(comm), device="cpu")

        def make_args(engine=engine):
            gen = torch.Generator().manual_seed(0)
            batches = {k: torch.empty(s, dtype=d)
                       for k, (s, d) in shapes.items()}
            return engine.init(gen), batches, gen
        per_round = traced_launches(api.Bundle(
            lambda st, b, g, engine=engine: engine.round(st, b, generator=g),
            make_args, {}))
        for k, v in per_round.items():
            want[k] += v * comm_compression.ROUNDS
        r = res[name]
        if not all(np.isfinite(r["losses"])):
            raise SystemExit(f"examples_check {name}: losses {r['losses']}")
        print(f"examples_check comm_compression {name}: "
              f"{r['wire']['total_bytes']} bytes a round, loss "
              f"{r['losses'][0]} -> {r['losses'][-1]}, test accuracy "
              f"{r['accuracy']}")
    check("comm_compression", got, want)
    del res

    for arch in SERVE_EXAMPLE_ARCHS:
        reset_launches()
        res = serve_batched.main(["--arch", arch])
        check(f"serve_batched {arch}", launch_counts(),
              {name: 0 for name in REPLACES})
        if not all(torch.isfinite(lg).all() for lg in res["logits"]):
            raise SystemExit(f"examples_check serve_batched {arch}: "
                             "logits not finite")
        print(f"examples_check serve_batched {arch}: tokens "
              f"{tuple(res['tokens'].shape)}; {card}")

    # Table I's twin: one cell, a few rounds (the CNN's direct parallel
    # round: one row-2 launch a local step)
    lr, J = HYPERPARAM_CELL
    reset_launches()
    res = hyperparam_table.run_cell(lr, J, device,
                                    hyperparam_table.make_data(device),
                                    rounds=HYPERPARAM_ROUNDS)
    check(f"hyperparam_table lr {lr} J {J}", launch_counts(),
          expect(sophia_update_leaves=HYPERPARAM_ROUNDS * J))
    if not (all(np.isfinite(res["losses"]))
            and all(0.0 <= a <= 1.0 for a in res["accs"])):
        raise SystemExit(f"examples_check hyperparam_table: losses "
                         f"{res['losses']}, accuracies {res['accs']}")
    print(f"examples_check hyperparam_table lr {lr} J {J}: "
          f"{HYPERPARAM_ROUNDS} rounds, losses {res['losses']}, test "
          f"accuracy {res['accs']}, {res['seconds_per_round']} s a round "
          f"(host clock after a synchronise; the first round builds); "
          f"{card}")
    return launches


def profile_round(engine, state, data, device, steady_s):
    """One more steady round of the main path under `torch.profiler`:
    device time by kernel, and the device's busy share of the
    unprofiled steady round time."""
    x, y, train_idx = data
    batches = syn.client_batches(gen(device, SEED + 200), x, y, train_idx,
                                 BATCH)
    noise = gen(device, SEED + 2000)
    return profile_call(lambda: engine.round(state, batches,
                                             generator=noise), steady_s)


#: device-activity classes of a profiled round, by words of the name
ACTIVITY_CLASSES = (("Sophia kernel", ("sophia",)),
                    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma",
                              "sm90_", "cublas")),
                    ("copy / cast", ("copy",)),
                    ("reduction", ("reduce",)),
                    ("index / gather / scatter", ("index", "gather",
                                                  "scatter")),
                    ("elementwise", ("elementwise",)))


def activity_class(name: str) -> str:
    low = name.lower()
    for label, words in ACTIVITY_CLASSES:
        if any(w in low for w in words):
            return label
    return "other"


def activity_op(name: str) -> str:
    """The op inside a templated PyTorch kernel's name (its functor or
    kernel function), where the name's head is only the template."""
    import re
    ops_ = re.findall(r"(\w+(?:Functor|_kernel_cuda|_kernel_impl|Ops))\b",
                      name)
    return ", ".join(dict.fromkeys(o for o in ops_
                                   if "gpu_kernel_impl" not in o)) or "-"


def profile_call(run, steady_s, top=8, spans=()):
    """``run()`` under `torch.profiler`: device time by activity name
    (name -> (us, count)), and the device's busy share of the
    unprofiled ``steady_s``; the ``top`` activities and the time of each
    class (`ACTIVITY_CLASSES`).  The device ranges of
    `torch.profiler.record_function` are not device activities and
    count in none of these; for each range name of ``spans`` the device
    time of the activities inside its ranges is returned (a range runs
    from the first to the last kernel launched inside it, and may hold
    idle gaps).  Returns ``(by_name, {span: us})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    ranges = {name: [] for name in spans}
    acts = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            if e.name in ranges:
                ranges[e.name].append((tr.start, tr.end))
            continue
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + tr.elapsed_us(), n + 1)
        acts.append((tr.start, tr.end))
    acts.sort()
    starts = [a for a, _ in acts]
    span_us = {}
    for name, rs in ranges.items():
        total = 0.0
        for lo, hi in rs:
            i = bisect.bisect_left(starts, lo)
            while i < len(acts) and acts[i][0] < hi:
                total += min(acts[i][1], hi) - acts[i][0]
                i += 1
        span_us[name] = total
    if not by_name:
        raise SystemExit("profile: the profiler recorded no device time")
    busy_us = sum(t for t, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    print(f"profiled round: {n_kernels} device activities, device busy "
          f"{busy_us} us; wall {wall * 1e6} us under the profiler, "
          f"busy share of the unprofiled steady round "
          f"{busy_us / (steady_s * 1e6)}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:top]:
        print(f"  {t:10.1f} us  {n:5d}x  {name[:90]}  [{activity_op(name)}]")
    classes: dict = {}
    for name, (t, n) in by_name.items():
        c = activity_class(name)
        ct, cn = classes.get(c, (0.0, 0))
        classes[c] = (ct + t, cn + n)
    print("  by class: " + "; ".join(
        f"{c} {t} us over {n} ({t / busy_us})" for c, (t, n) in
        sorted(classes.items(), key=lambda kv: -kv[1][0])))
    # the compressors' kernels and top-k's selection, wherever they rank
    comm = [(rank, name, t, n) for rank, (name, (t, n)) in enumerate(ranked)
            if any(w in name.lower() for w in COMM_KERNEL_WORDS)]
    for rank, name, t, n in comm:
        print(f"  comm stage, rank {rank + 1}: {t:10.1f} us  {n:5d}x  "
              f"{name[:80]}")
    return by_name, span_us


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
    t0 = time.perf_counter()
    err = check_kernels(device)
    err.update(check_quant_kernels(device))
    err.update(check_biased_kernels(device))
    err.update(check_agg_kernels(device))
    err.update(check_fused_step(device))
    print(f"phase wall seconds: kernel checks "
          f"{time.perf_counter() - t0:.1f}")

    def timed(fn, *args):
        """``fn(*args)``, printing its wall seconds (the run's time by
        phase, against its limit)."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase wall seconds: {fn.__name__} "
              f"{time.perf_counter() - t0:.1f}", flush=True)
        return out

    for check in (small_round_check, small_comm_round_check,
                  small_sched_check, small_robust_check,
                  small_settings_check):
        timed(check, device)
    launches, steady, narrow = timed(main_path, device)
    print(f"steady seconds per round by path: {json.dumps(steady)}")
    lm_launches = {fn.__name__: timed(fn, device) for fn in (
        lm_small_check, lm_train, lm_comm, lm_seq, lm_moe, lm_rec, lm_xlstm,
        lm_enc, lm_vlm, serve_small_check, lm_serve)}
    timed(dry_check, device)
    for path_launches in (*lm_launches.values(),
                          timed(examples_check, device)):
        for k, v in path_launches.items():
            launches[k] += v
    timing = timed(time_kernels, device)
    narrow_kernels = time_narrow(device, narrow)
    lm_timing = timed(time_lm_kernels, device)

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
    # the narrow forms of rows 2, 5 and 9: beside the 16, not among them
    print(json.dumps({"narrow_kernels": narrow_kernels}))
    # the LM slices' shapes of rows 2b, 4 and 5, with each LM phase's
    # launches of them: beside the 16, not among them
    print(json.dumps({"lm_kernels": [
        dict(name=name, slice=arch,
             launches={phase: counts[name] for phase, counts
                       in lm_launches.items() if counts[name] and (
                           phase == "lm_small_check"
                           or LM_PHASES[phase][0] == arch)},
             **t) for (name, arch), t in lm_timing.items()]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
