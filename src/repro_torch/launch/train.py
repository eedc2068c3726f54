"""Training launcher of the port: federated Fed-Sophia (or a baseline)
on an LM of the zoo, the twin of the JAX package's
``repro/launch/train.py`` with its arguments plus ``--device`` and
``--layers`` (cut the depth, keep the published widths; a depth below
the arch's block pattern keeps its first blocks, as JAX builds it, e.g.
xlstm-1.3b at 2 layers two mLSTM blocks).  An embedding-input arch
(qwen2-vl-2b, hubert-xlarge) trains on N(0, 1) input embeddings in its
dtype with the token batches' labels, as the JAX CLI builds them.  Runs on the
card; ``--device cpu`` runs the plain PyTorch versions of the kernels
(the tests' route).  Without a card and without that flag it raises:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --rounds 2 --device cpu

Flow, as in the JAX CLI: the engine state (``--resume``: params restored
from ``--ckpt-dir`` after its wire headers are checked), params packed
between rounds, then the plain synchronous loop (a host sync a round,
the loss print), the obs loop (``--obs-log``: metrics held on the
device in an `obs.MetricsAccumulator`, one host copy and the ``round``
records per flush), or the virtual-time scheduler (``--schedule
semisync|async``: its event records and spans), and a checkpoint
(``--ckpt-dir``) in the JAX package's format.  The checkpoint's save
and a resume's restore are timed on the host clock after a synchronise
and printed with the bytes written.

The arch file's ``FED`` overrides set the schedule and, unlike the JAX
CLI, which passes only ``schedule`` on, the strategy too: gemma2-9b,
qwen3-14b, deepseek-v2-lite-16b and qwen3-moe-235b-a22b train on the
sequential strategy, as their configs ask.

Randomness: the weights, the token batches, the input embeddings and
each round's GNB noise come from `torch.Generator`s seeded from
``--seed``.  `main` also takes
``hooks`` (the RNG seam of the tests): ``params`` (initial weights as
numpy arrays, flat or nested), ``batches`` (round -> batch dict),
``round_kwargs`` (round -> extra `FedEngine.round` arguments, e.g. the
injected ``gumbel``) and ``sched_draws`` (`VirtualScheduler.run`'s
``draws``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs, convert, obs, resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.comm import flat as cflat
from repro_torch.comm.accounting import round_bytes
from repro_torch.configs.base import (AGGREGATORS, ATTACKS, LATENCY_PROFILES,
                                      SCHED_DISCIPLINES, CommConfig,
                                      FedConfig, ObsConfig, RobustConfig,
                                      SchedConfig)
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as syn
from repro_torch.metrics import energy
from repro_torch.models import transformer as T
from repro_torch.robust import aggregators as robust_agg
from repro_torch.robust import attacks as robust_attacks
from repro_torch.sched import VirtualScheduler

#: generator salts: weights, round r's batches, round r's GNB noise,
#: round r's input embeddings (embedding-input archs)
_INIT_SALT, _BATCH_SALT, _ROUND_SALT, _EMBED_SALT = 0, 1000, 2000, 3000


def _generator(device, seed: int, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + salt)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Federated Fed-Sophia (or a baseline) on an LM of the "
                    "zoo, on the card (or --device cpu).")
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or "
                         "cpu (the plain PyTorch versions of the "
                         "kernels)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tau", type=int, default=5)
    ap.add_argument("--optimizer", default="fed_sophia")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model dims (CPU-feasible)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, keeping the "
                         "published widths (0 = the config's depth)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="kept for the JAX CLI's argument set: on the "
                         "card the fused Sophia kernel always runs")
    # communication layer (repro_torch.comm)
    ap.add_argument("--compressor", default="identity",
                    choices=("identity", "int8", "int4", "topk", "signsgd"),
                    help="uplink delta compressor")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round")
    ap.add_argument("--topk-ratio", type=float, default=0.01)
    ap.add_argument("--error-feedback", default="auto",
                    choices=("auto", "on", "off"),
                    help="per-client EF residuals (auto: biased "
                         "compressors only)")
    ap.add_argument("--sign-majority", action="store_true",
                    help="signsgd: server-side majority vote")
    ap.add_argument("--downlink-compressor", default="identity",
                    choices=("identity", "int8", "int4", "topk", "signsgd"),
                    help="server broadcast compressor (delta vs each "
                         "client's last-received model, server-side EF)")
    ap.add_argument("--hessian-compressor", default="off",
                    choices=("off", "identity", "int8", "int4", "topk",
                             "signsgd"),
                    help="Sophia h-EMA uplink compressor (curvature "
                         "averaging; 'off' keeps curvature local)")
    ap.add_argument("--comm-pallas", action="store_true",
                    help="kept for the JAX CLI's argument set: on the "
                         "card the quantize kernels always run")
    # device residency of the engine state
    ap.add_argument("--state-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="storage dtype of resident wire-layout state "
                         "(params between rounds, Sophia m/h, EF, "
                         "replicas); bfloat16 halves its HBM, compute "
                         "stays fp32")
    ap.add_argument("--moment-dtype", default="",
                    choices=("", "float32", "bfloat16",
                             "float8_e4m3fn", "float8_e5m2"),
                    help="per-buffer override of --state-dtype for the "
                         "Sophia first-moment stack (e4m3: more "
                         "mantissa; '' = follow --state-dtype)")
    ap.add_argument("--hessian-dtype", default="",
                    choices=("", "float32", "bfloat16",
                             "float8_e4m3fn", "float8_e5m2"),
                    help="per-buffer override of --state-dtype for the "
                         "hessian-EMA stack (e5m2: more range; "
                         "'' = follow --state-dtype)")
    ap.add_argument("--tree-state", action="store_true",
                    help="keep params as a dict between rounds and "
                         "run the scheduler's apply on copies (default: "
                         "packed params, updated in place)")
    # virtual-time round scheduling (repro_torch.sched)
    ap.add_argument("--schedule", default="sync",
                    choices=SCHED_DISCIPLINES,
                    help="round discipline: sync (today's engine), "
                         "semisync (FedBuff-style buffered rounds) or "
                         "async (per-arrival staleness-weighted apply)")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="semisync: arrivals aggregated per round "
                         "(0 = all in-flight participants)")
    ap.add_argument("--staleness-power", type=float, default=0.5,
                    help="arrival weight (1+staleness)^-p")
    ap.add_argument("--dispatch-chunk", type=int, default=0,
                    help="run dispatch groups larger than this as a "
                         "sequence of fixed-size chunks (0 = whole "
                         "group at once)")
    ap.add_argument("--latency-profile", default="uniform",
                    choices=LATENCY_PROFILES,
                    help="per-client latency model of the virtual clock")
    # adversarial fleet (repro_torch.robust)
    ap.add_argument("--aggregator", default="mean", choices=AGGREGATORS,
                    help="server-side combiner of client contributions "
                         "(degenerate parameterizations keep the mean "
                         "path bitwise)")
    ap.add_argument("--trim-fraction", type=float, default=0.0,
                    help="trimmed_mean: per-coordinate per-side trim "
                         "fraction of the arrival stack")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="norm_clip: max L2 norm per arrival (0 = off)")
    ap.add_argument("--attack", default="none", choices=ATTACKS,
                    help="byzantine wire attack applied to malicious "
                         "clients' packed uplink buffers")
    ap.add_argument("--attack-fraction", type=float, default=0.0,
                    help="fraction of clients byzantine")
    ap.add_argument("--attack-scale", type=float, default=10.0,
                    help="multiplier of the 'scale' attack")
    ap.add_argument("--label-noise-fraction", type=float, default=0.0,
                    help="fraction of clients training on corrupted "
                         "labels")
    ap.add_argument("--label-noise-rate", type=float, default=0.5,
                    help="per-sample corruption probability on "
                         "label-noise clients")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="per-dispatch client dropout probability on "
                         "the virtual clock (scheduler disciplines)")
    ap.add_argument("--rejoin-delay-s", type=float, default=0.0,
                    help="extra virtual seconds before a dropped "
                         "client's update is delivered")
    # structured telemetry (repro_torch.obs)
    ap.add_argument("--probes", action="store_true",
                    help="Sophia health probes in the round metrics "
                         "(clip fraction, m/h norms, curvature "
                         "freshness; fed_sophia only)")
    ap.add_argument("--trace", action="store_true",
                    help="per-dispatch trace contexts on the virtual "
                         "clock (sched_dispatch records + trace_ids; "
                         "export with tools/obs_trace.py)")
    ap.add_argument("--obs-log", default="",
                    help="write schema-validated JSONL telemetry to this "
                         "path (+ a .manifest.json on exit)")
    ap.add_argument("--obs-flush-every", type=int, default=10,
                    help="rounds per device-metrics flush (host syncs "
                         "only at this boundary in obs runs)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the run "
                         "into this directory (trace.json)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true",
                    help="restore params from --ckpt-dir first "
                         "(validates the checkpoint's wire-layout "
                         "headers against the current comm config)")
    ap.add_argument("--seed", type=int, default=0)

    return ap


def model_config(args) -> configs.ModelConfig:
    """The arch's `ModelConfig` as the parsed ``args`` ask: ``--reduced``
    widths, then ``--layers`` (the block pattern tiles the cut depth:
    gemma2-9b at 2 layers keeps one ``local`` and one ``global`` block;
    below the pattern's length the stacks are empty and the first blocks
    of the pattern remain: recurrentgemma-2b at 2 layers two ``rec``
    blocks)."""
    cfg = configs.get_model_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(d_model=128)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def comm_config(args) -> CommConfig:
    """The `CommConfig` of the parsed ``args``' comm and residency
    flags."""
    ef = {"auto": "auto", "on": True, "off": False}[args.error_feedback]
    return CommConfig(compressor=args.compressor,
                      participation=args.participation,
                      topk_ratio=args.topk_ratio,
                      error_feedback=ef,
                      sign_majority=args.sign_majority,
                      downlink_compressor=args.downlink_compressor,
                      hessian_compressor=args.hessian_compressor,
                      state_dtype=args.state_dtype,
                      moment_dtype=args.moment_dtype,
                      hessian_dtype=args.hessian_dtype,
                      use_pallas=args.comm_pallas)


def main(argv=None, *, hooks: Optional[Dict[str, Any]] = None
         ) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None).  Returns
    the engine, the final state, the per-round (or per-event) losses
    and host seconds, and the records the run emitted (with
    ``--obs-log``)."""
    args = build_parser().parse_args(argv)
    hooks = hooks or {}
    dev = resolve_device(args.device)

    cfg = model_config(args)
    over = configs.get_fed_overrides(args.arch)
    comm = comm_config(args)
    sched = SchedConfig(discipline=args.schedule,
                        buffer_size=args.buffer_size,
                        staleness_power=args.staleness_power,
                        dispatch_chunk=args.dispatch_chunk,
                        latency_profile=args.latency_profile)
    robust = RobustConfig(aggregator=args.aggregator,
                          trim_fraction=args.trim_fraction,
                          clip_norm=args.clip_norm,
                          attack=args.attack,
                          attack_fraction=args.attack_fraction,
                          attack_scale=args.attack_scale,
                          label_noise_fraction=args.label_noise_fraction,
                          label_noise_rate=args.label_noise_rate,
                          dropout_prob=args.dropout_prob,
                          rejoin_delay_s=args.rejoin_delay_s,
                          seed=args.seed)
    fed = FedConfig(num_clients=args.clients, local_iters=args.local_iters,
                    optimizer=args.optimizer, lr=args.lr, tau=args.tau,
                    total_rounds=args.rounds, use_pallas=args.use_pallas,
                    strategy=over.get("strategy", "parallel"),
                    schedule=over.get("schedule", "const"), comm=comm,
                    sched=sched, robust=robust,
                    obs=ObsConfig(probes=args.probes, trace=args.trace,
                                  flush_every=args.obs_flush_every))
    task = T.LMTask(cfg)
    engine = FedEngine(task, fed, device=dev)
    if "params" in hooks:
        params = convert.params_from_numpy(hooks["params"], dev)
    else:
        params = task.init(_generator(dev, args.seed, _INIT_SALT), dev)
    state = engine.init_from_params(params)
    # the state holds the weights now: once packed (below) the dict goes
    del params

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ckpt_times = {}
    if args.resume:
        manifest = ckpt.load_manifest(args.ckpt_dir)
        cflat.check_headers(manifest.get("extra", {}).get("wire", {}),
                            engine.wire_headers(state["params"]))
        sync()
        t0 = time.perf_counter()
        restored = ckpt.restore(args.ckpt_dir, state["params"])
        sync()
        ckpt_times["restore_s"] = time.perf_counter() - t0
        # re-sync the client state that references the model (downlink
        # replicas, EF residuals) to the restored params
        state = engine.restore_params(state, restored)
        del restored
        print(f"resumed params from {args.ckpt_dir} "
              f"(step {manifest['step']}, wire headers OK; restored in "
              f"{ckpt_times['restore_s']:.3f} s)")
    if not args.tree_state:
        # params stay packed in wire layout between rounds; dicts exist
        # only at the loss/grad and checkpoint boundaries
        state = engine.pack_state(state)

    n_params = engine.num_params(state)
    # exact integers from the accounting model; the records carry them
    # as exact int64 columns
    wire = round_bytes(comm, n_params, fed.num_clients)
    uplink_round = wire["uplink_bytes"]
    total_round = wire["total_bytes"]
    print(f"arch={cfg.name} params={n_params:,}"
          f" clients={fed.num_clients} J={fed.local_iters}"
          f" opt={fed.optimizer} compressor={comm.compressor}"
          f" downlink={comm.downlink_compressor}"
          f" hessian={comm.hessian_compressor}"
          f" participation={comm.participation:g} device={dev}")
    # the effective robust path of a full sync cohort (degenerate
    # parameterizations resolve to "mean")
    eff_agg = robust_agg.resolve(robust, wire["participants"])
    attack_on = robust_attacks.wire_attack_active(robust,
                                                 fed.num_clients)
    if eff_agg != "mean" or robust.adversarial:
        byz = [int(i) for i in
               robust_attacks.byzantine_mask(
                   robust, fed.num_clients).nonzero()[0]]
        print(f"adversarial fleet: aggregator={eff_agg} "
              f"attack={robust.attack if attack_on else 'none'} "
              f"byzantine={byz} "
              f"label_noise={robust.label_noise_fraction:g} "
              f"dropout={robust.dropout_prob:g}")
    print("per-round wire bytes: "
          + " ".join(f"{k}={wire[k]:,}" for k in
                     ("uplink_bytes", "downlink_bytes",
                      "hessian_uplink_bytes", "hessian_downlink_bytes",
                      "total_bytes")))
    rt = engine.runtime_for(state["params"])
    residency = "tree" if args.tree_state else "packed"
    dtypes = comm.state_dtype
    if comm.moment_dtype or comm.hessian_dtype:
        dtypes += (f" (m: {comm.moment_dtype or comm.state_dtype}, "
                   f"h: {comm.hessian_dtype or comm.state_dtype})")
    print(f"flat-resident state layout: {rt.spec.rows}x{rt.spec.cols} "
          f"{dtypes} ({rt.spec.total:,} coords + "
          f"{rt.spec.padded - rt.spec.total} pad), "
          f"between-round residency: {residency}")

    # per-round energy/carbon over the exact wire bytes (paper Eq.
    # 13-14), priced once: it is static in the config
    chan = energy.ChannelModel()
    comm_J = energy.tx_energy_joules(wire["total_bytes"], chan)
    # compute side: ~6*N FLOPs per trained token (fwd+bwd), J local
    # iterations per participant per round
    flops_iter = 6.0 * n_params * args.batch * args.seq
    compute_J = (energy.ComputeModel().energy_per_iteration(flops_iter)
                 * fed.local_iters * wire["participants"])
    round_J = comm_J + compute_J
    round_carbon = energy.footprint_kg_co2(round_J)

    recorder = None
    if args.obs_log:
        recorder = obs.RunRecorder(
            args.obs_log, ring_capacity=fed.obs.ring_capacity,
            meta={"arch": cfg.name, "params": n_params,
                  "clients": fed.num_clients,
                  "local_iters": fed.local_iters,
                  "optimizer": fed.optimizer,
                  "compressor": comm.compressor,
                  "schedule": args.schedule, "probes": fed.obs.probes,
                  "trace": fed.obs.trace, "residency": residency,
                  "state_dtype": comm.state_dtype,
                  "aggregator": robust.aggregator,
                  "attack": robust.attack, "device": str(dev)})

    noisy = robust_attacks.label_noise_mask(robust, fed.num_clients)

    def make_batches(r):
        if "batches" in hooks:
            batches = hooks["batches"](r)
        else:
            batches = syn.make_token_batch(
                _generator(dev, args.seed, _BATCH_SALT + r),
                fed.num_clients, args.batch, args.seq, cfg.vocab_size,
                device=dev)
        if noisy.any():
            # label-noise clients train on corrupted targets (host numpy
            # at data-build time)
            batches = dict(batches, labels=torch.as_tensor(
                robust_attacks.corrupt_labels(
                    robust, batches["labels"].cpu().numpy(), noisy,
                    cfg.vocab_size), device=dev))
        if cfg.embedding_inputs and "embeds" not in batches:
            # an embedding-input arch reads a frontend's output: N(0, 1)
            # frames in the parameters' dtype, with the token labels
            shape = tuple(batches["labels"].shape) + (cfg.d_model,)
            batches = {"embeds": torch.randn(
                shape, generator=_generator(dev, args.seed, _EMBED_SALT + r),
                device=dev).to(T.param_dtype(cfg)),
                "labels": batches["labels"]}
        return batches

    def round_kwargs(r):
        if "round_kwargs" in hooks:
            return hooks["round_kwargs"](r)
        return {"generator": _generator(dev, args.seed, _ROUND_SALT + r)}

    spans = obs.SpanLog()
    losses, seconds = [], []

    def round_line(r, loss, lr, dt, row=None):
        clip = (f" clip={row['clip_fraction']:.3f}"
                if row and "clip_fraction" in row else "")
        return (f"round {r:3d} loss={loss:.4f} lr={lr:.2e} "
                f"uplink={uplink_round / 2**20:.2f}MiB "
                f"total={total_round / 2**20:.2f}MiB "
                f"(cum {(r + 1) * total_round / 2**20:.2f}MiB)"
                f"{clip} ({dt:.1f}s)")

    def emit_round(r, row, wall_s):
        rec = {"record": "round", "round": r, "loss": row["loss"],
               "lr": row["lr"], "participants": wire["participants"],
               "cum_total_bytes": (r + 1) * total_round,
               "energy_J": round_J, "comm_J": comm_J,
               "compute_J": compute_J, "carbon_kg": round_carbon,
               "wall_s": wall_s}
        for k in ("uplink_bytes", "downlink_bytes",
                  "hessian_uplink_bytes", "hessian_downlink_bytes",
                  "total_bytes"):
            rec[k] = wire[k]
        for k in obs.PROBE_METRICS:
            if k in row:
                rec[k] = row[k]
        # robust context only when the run departs from the default
        # mean / no-attack path (optional schema fields)
        if eff_agg != "mean":
            rec["aggregator"] = eff_agg
        if attack_on:
            rec["attack"] = robust.attack
        recorder.emit(rec)

    with obs.profile_trace(args.profile_dir):
        if args.schedule == "sync" and recorder is None:
            # the plain synchronous loop: the per-round host sync is the
            # loss print itself
            for r in range(args.rounds):
                t0 = time.perf_counter()
                with spans.span("round"):
                    state, metrics = engine.round(
                        state, make_batches(r), **round_kwargs(r))
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                losses.append(loss)
                seconds.append(dt)
                print(round_line(r, loss, float(metrics["lr"]), dt),
                      flush=True)
        elif args.schedule == "sync":
            # obs loop: round metrics (and the probes) accumulate in a
            # device-side buffer; the host syncs, records and prints
            # only at the flush boundary
            acc = obs.MetricsAccumulator(fed.obs.flush_every)
            pending = []
            t0 = time.perf_counter()
            for r in range(args.rounds):
                with spans.span("round"):
                    state, metrics = engine.round(
                        state, make_batches(r), **round_kwargs(r))
                acc.add(metrics)
                pending.append(r)
                if len(acc) == fed.obs.flush_every or r == args.rounds - 1:
                    with spans.span("flush"):
                        rows = acc.flush()
                    dt = (time.perf_counter() - t0) / len(pending)
                    for rr, row in zip(pending, rows):
                        emit_round(rr, row, dt)
                        losses.append(row["loss"])
                        seconds.append(dt)
                        print(round_line(rr, row["loss"], row["lr"], dt,
                                         row), flush=True)
                    pending = []
                    t0 = time.perf_counter()
        else:
            # virtual-time event loop: --rounds counts aggregation
            # events; the printed time is SIMULATED seconds
            scheduler = VirtualScheduler(engine, make_batches,
                                         donate=not args.tree_state)
            t0 = time.perf_counter()
            state, trace = scheduler.run(
                state, args.rounds,
                _generator(dev, args.seed, _ROUND_SALT),
                draws=hooks.get("sched_draws"))
            sync()
            dt = (time.perf_counter() - t0) / max(len(trace.events), 1)
            for ev in trace.events:
                stale = max(ev.staleness) if ev.staleness else 0
                clip = (f" clip={ev.probes['clip_fraction']:.3f}"
                        if ev.probes else "")
                losses.append(ev.loss)
                seconds.append(dt)
                print(f"event {ev.version:3d} t={ev.time:9.2f}s "
                      f"loss={ev.loss:.4f} clients={list(ev.clients)} "
                      f"max_stale={stale} "
                      f"cum={ev.cum_bytes / 2**20:.2f}MiB{clip}",
                      flush=True)
            print(f"{args.schedule}: {len(trace.events)} events, "
                  f"simulated {trace.final_time:.2f}s, "
                  f"{trace.total_bytes / 2**20:.2f}MiB on the wire")
            if recorder is not None:
                # the event records (exact per-stream int64 byte
                # counters, staleness histogram, per-event energy),
                # then the scheduler's own span timers
                recorder.emit_all(trace.to_records(channel=chan))
                recorder.emit_all(scheduler.spans.records())
    records = None
    if recorder is not None:
        recorder.emit_all(spans.records())
        recorder.close()
        records = recorder.ring.records()
        print(f"wrote {recorder.counts} obs records to {args.obs_log} "
              f"(+ {recorder.manifest_path})")
    if args.ckpt_dir:
        extra = {"arch": args.arch,
                 "wire": engine.wire_headers(state["params"])}
        sync()
        t0 = time.perf_counter()
        if engine.params_packed(state["params"]):
            # the on-disk format is the params tree whatever the
            # between-round residency
            ckpt.save_packed(args.ckpt_dir, state["params"], rt.spec,
                             step=args.rounds, extra=extra)
        else:
            ckpt.save(args.ckpt_dir, state["params"], step=args.rounds,
                      extra=extra)
        ckpt_times["save_s"] = time.perf_counter() - t0
        ckpt_times["save_bytes"] = os.path.getsize(
            os.path.join(args.ckpt_dir, "arrays.npz"))
        print(f"saved checkpoint to {args.ckpt_dir} "
              f"({ckpt_times['save_bytes']:,} bytes of arrays in "
              f"{ckpt_times['save_s']:.3f} s)")
    return {"engine": engine, "state": state, "losses": losses,
            "seconds": seconds, "records": records, "ckpt": ckpt_times}


if __name__ == "__main__":
    main()
