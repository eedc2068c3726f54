"""Dry run of every (architecture x input shape) on one card: the twin of
the JAX package's ``launch/dryrun.py``.  Where the JAX version lowers and
compiles each combination on a 512-device placeholder mesh, this one
traces it under ``FakeTensorMode`` with `op_cost.OpCost`: every aten op
and every kernel launch, with shapes and dtypes and no storage, so the
full published sizes trace on a host without a card in seconds.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --local-iters 2 [--reduced] [--memory-bytes N]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \
        --check-donation

A record (``build/dryrun/<arch>_<shape>_card.json``) keeps the JAX
record's ``status``, ``entry``, ``roofline`` (the card's peaks,
`roofline`), ``params``, ``model_flops_total``, ``useful_flops_ratio``,
``bytes_by_opcode``, ``flops_by_opcode`` and ``collective_bytes`` (0 on
one card); the traced counts are ``op_flops_per_dev`` and
``op_bytes_per_dev``; it adds ``trace_s``, ``peak_bytes`` (live storages
at their most), ``launches`` (each kernel of the table), ``roofline_s``
(each op's larger roofline term, summed), ``flops_by_dtype`` and
``fits``: ``peak_bytes`` within the card's ``total_memory`` when a card
is present, else within ``--memory-bytes``, else null.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import api
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import (collective_bytes, count_params,
                                         model_flops, roofline_terms)

DEFAULT_OUT_DIR = "build/dryrun"


def trace(bundle: api.Bundle) -> OpCost:
    """``bundle.fn(*bundle.make_args())`` under ``FakeTensorMode`` and an
    `OpCost`: the arguments' storages count toward the peak, their ops
    are not tallied.  Fallback kernels are off, so an op without a fake
    implementation raises instead of running on real zeros."""
    with FakeTensorMode(allow_fallback_kernels=False), OpCost() as oc:
        with oc.setup():
            args = bundle.make_args()
        out = bundle.fn(*args)
        del out, args
    return oc


def capacity_bytes(memory_bytes: Optional[int] = None) -> Optional[int]:
    """The card's ``total_memory`` when a card is present, else
    ``memory_bytes`` (None when not given: nothing is invented)."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return memory_bytes


def _resident(state) -> dict:
    """name -> tensor of every resident buffer of an engine state."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        elif hasattr(v, "_fields"):
            out.update({f"{k}/{f}": getattr(v, f) for f in v._fields})
    return out


def run_donation_check(arch: str, *, local_iters: int = 2,
                       out_dir: str = "", tag: str = "") -> dict:
    """The packed-resident round on one card keeps every resident
    buffer's storage (the counterpart of the JAX check that donation
    survives partitioning): a reduced round is traced, and
    ``state_copy_bytes`` are the bytes of the resident buffers whose
    storage is new after it.  It must be 0."""
    rec = {"arch": arch, "check": "donation-aliasing", "mesh": "card"}
    try:
        bundle = api.build_train(arch, reduced=True,
                                 local_iters=local_iters, packed_state=True)
        with FakeTensorMode(allow_fallback_kernels=False), OpCost():
            state, batches, gen = bundle.make_args()
            before = {k: t.untyped_storage()._cdata
                      for k, t in _resident(state).items()}
            new_state, _ = bundle.fn(state, batches, gen)
            after = _resident(new_state)
            resident = sum(t.untyped_storage().nbytes()
                           for t in after.values())
            copied = {k: t.untyped_storage().nbytes()
                      for k, t in after.items()
                      if before.get(k) != t.untyped_storage()._cdata}
        copy_b = sum(copied.values())
        rec.update(status="ok" if copy_b == 0 else "error",
                   resident_bytes=resident, state_copy_bytes=copy_b,
                   copied=copied)
        if copy_b:
            rec["error"] = (f"resident buffers not kept in place: "
                            f"{copy_b} of {resident} bytes ({copied})")
    except Exception as e:                            # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _save(rec, out_dir, arch, "donation", "fed_sophia", tag)
    return rec


def parse_overrides(s: str) -> dict:
    """'k=v,k2=v2' -> {k: v} (values stay strings; api coerces)."""
    out = {}
    for kv in (s or "").split(","):
        if "=" in kv:
            k, _, v = kv.partition("=")
            out[k.strip()] = v.strip()
    return out


def run_one(arch: str, shape: str, *, reduced: bool = False,
            optimizer: str = "fed_sophia", local_iters: int = 10,
            out_dir: str = DEFAULT_OUT_DIR, tag: str = "",
            cfg_overrides: dict | None = None,
            fed_overrides: dict | None = None,
            memory_bytes: Optional[int] = None) -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": "card",
           "optimizer": optimizer, "tag": tag}
    ok, reason = api.applicable(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _save(rec, out_dir, arch, shape, optimizer, tag)
        return rec
    t0 = time.perf_counter()
    try:
        kw = {"cfg_overrides": cfg_overrides}
        if INPUT_SHAPES[shape].kind == "train":
            kw.update(optimizer=optimizer, local_iters=local_iters,
                      fed_overrides=fed_overrides)
        bundle = api.build(arch, shape, reduced=reduced, **kw)
        oc = trace(bundle)
        trace_s = time.perf_counter() - t0
        s = oc.summary()
        cfg = bundle.meta["cfg"]
        flops, byts = float(s["flops"]), float(s["bytes"])
        mflops = (model_flops(cfg, shape, local_iters=local_iters)
                  if not reduced else 0.0)
        cap = capacity_bytes(memory_bytes)
        rec.update(
            status="ok",
            trace_s=trace_s,
            trace_device=api.TRACE_DEVICE + " (fake tensors)",
            entry=bundle.meta["entry"],
            op_flops_per_dev=flops,
            op_bytes_per_dev=byts,
            flops_by_dtype=s["flops_by_dtype"],
            collective_bytes=collective_bytes(),
            roofline=roofline_terms(s["flops_by_dtype"], byts),
            roofline_s=s["roofline_s"],
            params=count_params(cfg),
            model_flops_total=mflops,
            useful_flops_ratio=(mflops / flops if flops and mflops
                                else None),
            peak_bytes=s["peak_bytes"],
            memory_bytes=cap,
            fits=None if cap is None else s["peak_bytes"] <= cap,
            launches=s["launches"],
            bytes_by_opcode=s["bytes_by_opcode"],
            flops_by_opcode=s["flops_by_opcode"],
        )
    except Exception as e:                            # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _save(rec, out_dir, arch, shape, optimizer, tag)
    return rec


def _save(rec, out_dir, arch, shape, optimizer, tag):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{arch}_{shape}_card"
    if optimizer != "fed_sophia":
        fn += f"_{optimizer}"
    if tag:
        fn += f"_{tag}"
    with open(os.path.join(out_dir, fn + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def line_of(rec: dict) -> str:
    """The one-line report of a record."""
    line = f"[{rec['status']:7s}] {rec['arch']:24s} {rec['shape']:12s} card"
    if rec["status"] == "ok":
        r = rec["roofline"]
        line += (f" trace={rec['trace_s']:.1f}s"
                 f" flops={rec['op_flops_per_dev']:.4g}"
                 f" bytes={rec['op_bytes_per_dev']:.4g}"
                 f" peak={rec['peak_bytes']:.4g}B fits={rec['fits']}"
                 f" bottleneck={r['bottleneck']}")
    elif rec["status"] == "skipped":
        line += f" ({rec['reason']})"
    else:
        line += f" {rec['error'][:160]}"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="one-card dry run: each combination traced under "
                    "FakeTensorMode (no card needed)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model dims (CI smoke)")
    ap.add_argument("--optimizer", default="fed_sophia")
    ap.add_argument("--local-iters", type=int, default=10)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--overrides", default="",
                    help="ModelConfig overrides, e.g. num_layers=4")
    ap.add_argument("--fed-overrides", default="",
                    help="FedConfig overrides, e.g. hessian_every_unit=round")
    ap.add_argument("--memory-bytes", type=int, default=None,
                    help="the capacity `fits` compares with when no card "
                         "is present (default: none, fits is null)")
    ap.add_argument("--check-donation", action="store_true",
                    help="trace the packed-resident round and assert that "
                         "every resident buffer keeps its storage")
    args = ap.parse_args(argv)
    archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
    failures = 0
    if args.check_donation:
        for arch in archs:
            rec = run_donation_check(arch, local_iters=args.local_iters,
                                     out_dir=args.out_dir, tag=args.tag)
            line = f"[{rec['status']:7s}] {arch:24s} donation card"
            if rec["status"] == "ok":
                line += (f" resident={rec['resident_bytes']}B"
                         f" state_copy_B={rec['state_copy_bytes']}")
            else:
                line += f" {rec['error'][:160]}"
                failures += 1
            print(line, flush=True)
        raise SystemExit(1 if failures else 0)
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, reduced=args.reduced,
                          optimizer=args.optimizer,
                          local_iters=args.local_iters,
                          out_dir=args.out_dir, tag=args.tag,
                          cfg_overrides=parse_overrides(args.overrides),
                          fed_overrides=parse_overrides(args.fed_overrides),
                          memory_bytes=args.memory_bytes)
            failures += rec["status"] == "error"
            print(line_of(rec), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
