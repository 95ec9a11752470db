"""Serving entry point of the port (speculative generation, lock-step or
continuous).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --continuous [--slots 4] [--requests 16]

``--smoke`` runs batched speculative generation of the reduced config
(``smoke_variant``) with random weights from ``--seed``, ``--rounds``
times over a stream of repeated problems, so later rounds draft from
earlier rounds' rollouts. With ``--continuous`` the request stream flows
through the slot-recycling pool (``--slots`` device rows,
longest-predicted-first admission) and each request is reported as it
finishes. It runs on CUDA unless ``--device cpu`` is given.

``--history-dir DIR`` starts the drafter from a persisted rollout
history (``history.persist`` format: warm suffix trees, warm length
priors); ``--save-history`` writes the updated history back on exit.

``--history-service`` runs the smoke through the sharded cross-worker
history service: ``--shards`` shards (subprocesses running ``python -m
repro_torch.history.service``, or threads with ``--service-mode
thread``) and ``--workers`` engines whose drafters publish rollouts to,
and replicate packed-forest deltas from, the shared service. It needs a
tree-only ``--scope`` (problem or global). ``--supervise`` restarts dead
shards; ``--watchdog-deadline`` deadlines each worker's rounds.

``--journal-dir D`` journals every consumed verify round (write-ahead,
one group commit a round); on startup the journal's unfinished sessions
are recovered and resumed token-identically (T=0) before new traffic.
``--drain-deadline`` installs the SIGTERM/SIGINT drain. Under the
history service each worker journals to ``D/w<k>.wal``.

``--metrics-port P`` serves Prometheus text on
``http://127.0.0.1:P/metrics`` (one endpoint per worker at ``P + w``);
``--log-every N`` logs a round-timing line every N rounds; ``--trace-out
F`` writes a Perfetto/Chrome trace of the run (spans and per-rollout
flight events, one track per worker).

``--dry-run`` counts the full config's serve step (``--shape``:
``decode_32k`` by default, ``long_500k`` or ``verify_8``) on the
production mesh (``--multi-pod``: 2×16×16) with ``launch.dryrun``: on
meta tensors, allocating nothing on any device, so it runs with or
without a card; it prints the record as one JSON line. An
encoder-decoder (``--arch seamless-m4t-medium``) is refused with the
reference's reason: its ``SpecEngine`` does not serve one either.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger("repro_torch.launch.serve")


def _setup_logging() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )


def _make_telemetry(args, worker: int = 0):
    """One (Telemetry, MetricsServer) pair per worker when
    ``--metrics-port`` is set; the NULL telemetry otherwise.
    ``--trace-out`` forces a real telemetry (the flight recorder and the
    span tracer feed the trace) even with metrics off."""
    from repro_torch import obs

    if args.metrics_port < 0 and not args.trace_out:
        return obs.NULL, None
    tel = obs.Telemetry()
    if args.trace_out:
        tel.attach_flight(worker=f"w{worker}")
    server = None
    if args.metrics_port >= 0:
        server = obs.MetricsServer(
            tel,
            port=(args.metrics_port + worker if args.metrics_port else 0),
        ).start()
        log.info("worker %d metrics at %s/metrics", worker, server.url)
    return tel, server


def _export_trace(args, tels, names=None) -> None:
    """Write the combined Perfetto/Chrome trace (``--trace-out``)."""
    if not args.trace_out:
        return
    from repro_torch import obs

    doc = obs.export_trace(args.trace_out, tels, names=names)
    log.info("wrote trace: %d event(s) -> %s",
             len(doc.get("traceEvents", ())), args.trace_out)


def _engine_config(args):
    from repro_torch.core.spec_engine import EngineConfig

    return EngineConfig(spec_enabled=True, max_new_tokens=32, eos_token=1,
                        max_draft=8, block_buckets=(0, 4, 8),
                        fuse_rounds=args.fuse)


def _generator(dev, seed: int):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions of "
                         "the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fuse", default="auto", choices=["auto", "on", "off"],
                    help="fused device-resident rounds; 'off' keeps the "
                         "unfused loop")
    ap.add_argument("--scope", default="problem+request",
                    choices=["problem", "problem+request", "global"],
                    help="drafter scope (fused rounds need a tree-only "
                         "scope: problem or global)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching through a slot pool")
    ap.add_argument("--slots", type=int, default=4,
                    help="device slots in the continuous pool")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests per round in continuous mode "
                         "(default: 2 x --batch)")
    ap.add_argument("--history-dir", default="",
                    help="load persisted rollout history (warm trees and "
                         "length priors) from this directory")
    ap.add_argument("--save-history", action="store_true",
                    help="persist the updated history to --history-dir "
                         "on exit")
    ap.add_argument("--history-service", action="store_true",
                    help="back the drafters with the sharded cross-worker "
                         "history service")
    ap.add_argument("--shards", type=int, default=2,
                    help="history-service shard count")
    ap.add_argument("--workers", type=int, default=2,
                    help="serving workers sharing the history service")
    ap.add_argument("--service-mode", default="process",
                    choices=["process", "thread"],
                    help="shards as subprocesses or in-process threads")
    ap.add_argument("--supervise", action="store_true",
                    help="run a shard supervisor: dead shards restart "
                         "with backoff and republish their addresses")
    ap.add_argument("--watchdog-deadline", type=float, default=120.0,
                    help="per-worker rollout watchdog deadline in seconds "
                         "(0 disables it; it covers the first round, which "
                         "builds the kernels)")
    ap.add_argument("--journal-dir", default="",
                    help="write-ahead token journal directory; unfinished "
                         "sessions found there are resumed first")
    ap.add_argument("--drain-deadline", type=float, default=30.0,
                    help="graceful-drain deadline in seconds (0 disables "
                         "the SIGTERM/SIGINT handlers)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus /metrics on this port (0 = "
                         "ephemeral; one endpoint per worker at PORT+w)")
    ap.add_argument("--log-every", type=int, default=1,
                    help="log a round-timing line every N rounds (0 "
                         "silences them; events are still recorded)")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/Chrome trace-event JSON of the "
                         "run")
    ap.add_argument("--dry-run", action="store_true",
                    help="count the full config's serve step on the "
                         "production mesh (launch.dryrun, meta tensors)")
    ap.add_argument("--shape", default="decode_32k",
                    choices=["decode_32k", "long_500k", "verify_8"],
                    help="with --dry-run: the serve workload")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dry-run: the 2x16x16 mesh")
    args = ap.parse_args()
    if args.dry_run:
        import json

        from repro_torch.launch import dryrun

        rec = dryrun.dry_run_one(args.arch, args.shape,
                                 multi_pod=args.multi_pod)
        print(json.dumps(rec, default=str), flush=True)
        raise SystemExit(0 if rec["status"] in ("ok", "skipped") else 1)
    if not args.smoke:
        ap.error("only --smoke serving is ported so far")
    if args.save_history and not args.history_dir:
        ap.error("--save-history requires --history-dir")
    if args.history_service and args.scope == "problem+request":
        ap.error("--history-service needs a tree-only scope: pass "
                 "--scope problem (or global)")

    _setup_logging()

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config(args.arch))
    if cfg.is_encoder_decoder:  # as the reference refuses it
        raise SystemExit(
            "enc-dec serving smoke isn't wired through SpecEngine; use "
            "tests/test_torch_encdec.py (encode, build_cross_cache and the "
            "cross-cached decode against the reference)"
        )
    dev = resolve_device(args.device)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    if args.history_service:
        _serve_with_service(args, cfg, params, dev)
        return
    _serve_single(args, cfg, params, dev)


def _serve_single(args, cfg, params, dev) -> None:
    import numpy as np

    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import SpecEngine

    tel, metrics_server = _make_telemetry(args)
    eng = SpecEngine(
        params, cfg, _engine_config(args),
        drafter=SuffixDrafter(DrafterConfig(scope=args.scope, min_match=2)),
        telemetry=tel, device=dev,
    )
    if args.history_dir:
        import os

        from repro_torch.history import persist

        if os.path.exists(persist.history_path(args.history_dir)):
            persist.load_engine_history(eng, args.history_dir)
            log.info("warm start: %d rollouts / %d problems from %s",
                     eng.drafter.store.n_rollouts,
                     eng.drafter.store.n_problems, args.history_dir)
        else:
            log.info("cold start: no history at %s", args.history_dir)
    journal, recovered = _open_journal(args, tel, "serve.wal")
    drain = None
    if args.drain_deadline > 0:
        from repro_torch.fault.drain import DrainController

        drain = DrainController(args.drain_deadline, telemetry=tel).install()
    rng = np.random.default_rng(args.seed)
    try:
        _serve_rounds(args, eng, rng, tel, dev, journal=journal,
                      drain=drain, recovered=recovered)
    finally:
        # persist whatever history accumulated, interrupted or not
        if journal is not None:
            journal.close()
        if drain is not None:
            drain.uninstall()
        if args.history_dir and args.save_history:
            from repro_torch.history import persist

            path = persist.save_engine_history(eng, args.history_dir)
            log.info("saved history: %d rollouts -> %s",
                     eng.drafter.store.n_rollouts, path)
        _export_trace(args, [tel])
        if metrics_server is not None:
            metrics_server.stop()


def _open_journal(args, tel, name: str):
    """Open a write-ahead journal under ``--journal-dir`` (None when it
    is unset). An existing journal is replayed first: its unfinished
    sessions come back as salvage to resume."""
    if not args.journal_dir:
        return None, {}
    import os

    from repro_torch.fault.journal import JournalCorruptError, RolloutJournal

    os.makedirs(args.journal_dir, exist_ok=True)
    path = os.path.join(args.journal_dir, name)
    recovered = {}
    if os.path.exists(path):
        try:
            sessions = RolloutJournal.recover(path, telemetry=tel)
        except JournalCorruptError as e:
            log.warning("journal quarantined (%s); cold start", e)
            sessions = {}
        recovered = {
            k: s for k, s in sessions.items() if s.resumable and s.tokens
        }
        log.info(
            "journal recovery: %d finished, %d in-flight session(s), "
            "%d salvaged token(s)",
            sum(s.finished for s in sessions.values()), len(recovered),
            sum(len(s.tokens) for s in recovered.values()),
        )
    journal = RolloutJournal(path, telemetry=tel)
    journal.adopt(recovered)
    return journal, recovered


def _log_round(args, tel, rnd: int, msg: str, *fmt_args, **event) -> None:
    """Round-timing line: always in the structured event log, printed
    through ``logging`` every ``--log-every`` rounds."""
    tel.emit("serve_round_done", round=rnd, **event)
    if args.log_every > 0 and rnd % args.log_every == 0:
        log.info(msg, *fmt_args)


def _smoke_requests(args, rng, rnd: int = 0, worker: int = 0):
    """One round's long-tailed request stream (``--requests``); worker
    ``w`` serves a rotated partition, so it drafts from peers' history."""
    from repro_torch.core.scheduler import Request

    n_req = args.requests or 2 * args.batch
    reqs = []
    for i in range(n_req):
        seed = (i + worker + rnd) % 4
        reqs.append(Request(
            rid=i, problem_id=f"q{seed}",
            prompt=[2] + list(rng.integers(4, 20, size=4 + seed)),
            max_new_tokens=8 * (1 + seed),
        ))
    return reqs


def _serve_with_service(args, cfg, params, dev) -> None:
    """Multi-worker serving over the sharded history service: one engine
    per worker on the one parameter object, each round's traffic
    partitioned across the workers (rotated), each worker's publishes
    flushed before the next worker runs."""
    import os
    import time

    import numpy as np

    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import SpecEngine
    from repro_torch.history import persist
    from repro_torch.history.client import HistoryClient
    from repro_torch.history.service import HistoryService

    states = None
    if args.history_dir and (
        os.path.exists(os.path.join(args.history_dir,
                                    persist.MANIFEST_FILENAME))
        or os.path.exists(persist.history_path(args.history_dir))
    ):
        loaded = persist.load_service_history(args.history_dir)
        states = loaded["shards"]
        log.info("warm start: %d shard(s) from %s", loaded["n_shards"],
                 args.history_dir)
    if args.service_mode == "thread":
        svc = HistoryService.spawn_in_process(args.shards, window_size=16,
                                              states=states)
    else:  # subprocess shards load from disk themselves
        svc = HistoryService.spawn_subprocess(
            args.shards, window_size=16,
            load_dir=args.history_dir if states is not None else None,
        )
    epoch0 = max((int(st["store"]["epoch"]) for st in states or []
                  if st is not None), default=0)
    tels, metric_servers = [], []
    for w in range(args.workers):
        tel, srv = _make_telemetry(args, worker=w)
        tels.append(tel)
        metric_servers.append(srv)
    if tels[0].enabled:
        svc.attach_telemetry(tels[0])
    supervisor = None
    engines, clients, watchdogs, journals = [], [], [], []
    try:
        if args.supervise:
            from repro_torch.fault.supervisor import ShardSupervisor

            supervisor = ShardSupervisor(svc, seed=0, telemetry=tels[0])
            supervisor.start(interval_s=1.0)
        for w in range(args.workers):
            # svc.book is live: a supervised restart republishes the new
            # shard address to every client
            client = HistoryClient(svc.book, worker_id=f"w{w}")
            clients.append(client)
            if tels[w].enabled:
                client.attach_telemetry(tels[w])
            eng = SpecEngine(
                params, cfg, _engine_config(args),
                drafter=SuffixDrafter(
                    DrafterConfig(scope=args.scope, min_match=2),
                    remote=client),
                telemetry=tels[w], device=dev,
            )
            eng.epoch = eng.drafter.epoch = epoch0
            engines.append(eng)
            watchdog = None
            if args.watchdog_deadline > 0:
                from repro_torch.fault.watchdog import RolloutWatchdog

                watchdog = RolloutWatchdog(args.watchdog_deadline,
                                           flight=tels[w].flight)
            watchdogs.append(watchdog)
            journal, recovered = _open_journal(args, tels[w], f"w{w}.wal")
            journals.append(journal)
            if recovered:
                _resume_recovered(args, eng, dev, journal, None, recovered)
        log.info("history service: %d shard(s) [%s] x %d worker(s) at %s",
                 args.shards, args.service_mode, args.workers,
                 svc.addresses)
        rng = np.random.default_rng(args.seed)
        base_epoch = max(e.epoch for e in engines)
        for rnd in range(args.rounds):
            t0 = time.perf_counter()
            fwd = acc = rds = 0
            for w, eng in enumerate(engines):
                reqs = _smoke_requests(args, rng, rnd, w)
                prompts = [r.prompt for r in reqs]
                pids = [r.problem_id for r in reqs]
                gen = _generator(dev, rnd * 31 + w)
                if args.continuous:
                    _, st = eng.generate_continuous(
                        prompts, pids, slots=args.slots,
                        max_new_tokens=[r.max_new_tokens for r in reqs],
                        generator=gen, watchdog=watchdogs[w],
                        journal=journals[w],
                        journal_keys=[f"r{rnd}-{i}" for i in range(len(reqs))],
                    )
                else:
                    _, st = eng.generate(
                        prompts, pids, generator=gen,
                        watchdog=watchdogs[w], journal=journals[w],
                        journal_keys=[f"r{rnd}-{i}" for i in range(len(reqs))],
                    )
                clients[w].flush()
                fwd += st.n_fwd
                acc += st.n_accepted
                rds += st.n_rounds
            dt = time.perf_counter() - t0
            _log_round(
                args, tels[0], rnd,
                "round %d: %8.1f ms  fwd=%4d accept/round=%6.2f device=%s",
                rnd, dt * 1e3, fwd, acc / max(rds, 1), dev,
                ms=dt * 1e3, fwd=fwd, accept_per_round=acc / max(rds, 1),
            )
            for eng in engines:
                eng.begin_iteration(base_epoch + rnd + 1)
        if args.history_dir and args.save_history:
            for c in clients:
                c.flush()
            path = svc.save(args.history_dir)
            log.info("saved sharded history manifest -> %s", path)
    finally:
        if supervisor is not None:
            # stop before the service so no restart races the shutdown
            supervisor.stop()
        for c in clients:
            c.close()
        for j in journals:
            if j is not None:
                j.close()
        svc.stop()
        _export_trace(args, tels,
                      names=[f"w{w}" for w in range(args.workers)])
        for srv in metric_servers:
            if srv is not None:
                srv.stop()


def _resume_recovered(args, eng, dev, journal, drain, recovered) -> None:
    """Serve the journal's unfinished sessions to completion before new
    traffic: prompts and limits come from the journal's begin records,
    salvaged tokens re-enter by prefix re-prefill (token-identical at
    temperature 0)."""
    from repro_torch.core.scheduler import Request
    from repro_torch.core.spec_engine import RolloutStats
    from repro_torch.fault.journal import resume_requests

    reqs = [
        Request(rid=i, problem_id=s.problem_id, prompt=list(s.prompt),
                max_new_tokens=s.max_new_tokens or args.batch,
                journal_key=s.key)
        for i, s in enumerate(recovered.values())
    ]
    to_serve, pre_done = resume_requests(reqs, recovered)
    log.info("resuming %d journaled request(s) (%d restored without "
             "serving)", len(to_serve), len(pre_done))
    if not to_serve:
        return
    st = RolloutStats()
    for fin in eng.serve(to_serve, slots=args.slots,
                         generator=_generator(dev, 0xD5), stats=st,
                         journal=journal, drain=drain):
        log.info("  resumed req %3d (%s) done: %3d toks (state %s)",
                 fin.rid, fin.problem_id, len(fin.output), fin.state)


def _serve_rounds(args, eng, rng, tel, dev, journal=None, drain=None,
                  recovered=None) -> None:
    import time

    # Continue the (possibly warm-restored) epoch cursor.
    base_epoch = eng.epoch
    if recovered:
        _resume_recovered(args, eng, dev, journal, drain, recovered)

    if args.continuous:
        from repro_torch.core.spec_engine import RolloutStats

        for rnd in range(args.rounds):
            reqs = _smoke_requests(args, rng)
            for r in reqs:  # journal keys unique across rounds
                r.journal_key = f"r{rnd}-{r.rid}"
            st = RolloutStats()
            t0 = time.perf_counter()
            for fin in eng.serve(reqs, slots=args.slots,
                                 generator=_generator(dev, rnd), stats=st,
                                 journal=journal, drain=drain):
                log.info("  req %3d (%s) done: %3d toks, rounds %d->%d",
                         fin.rid, fin.problem_id, len(fin.output),
                         fin.admit_round, fin.finish_round)
            dt = time.perf_counter() - t0
            print(  # dascheck: disable=DAS304 -- the CLI's round summary line on stdout, as main() printed it before
                f"round {rnd}: {dt * 1e3:8.1f} ms {len(reqs)} reqs / "
                f"{args.slots} slots makespan={st.n_rounds} rounds "
                f"fwd={st.n_fwd:4d} "
                f"tok/s={st.n_toks_emitted / max(dt, 1e-9):7.1f} "
                f"accept/round={st.acceptance_per_round:6.2f} device={dev}",
                flush=True,
            )
            _log_round(args, tel, rnd, "round %d done", rnd,
                       ms=dt * 1e3, reqs=len(reqs), fwd=st.n_fwd,
                       accept_per_round=st.acceptance_per_round)
            if drain is not None and drain.draining:
                log.info("drain (%s): stopping after round %d; unfinished "
                         "progress is journaled", drain.reason, rnd)
                break
            eng.begin_iteration(base_epoch + rnd + 1)
        return

    for rnd in range(args.rounds):
        prompts, pids = [], []
        for b in range(args.batch):
            seed = b % 4
            prompts.append([2] + list(rng.integers(4, 20, size=4 + seed)))
            pids.append(f"q{seed}")
        t0 = time.perf_counter()
        outs, st = eng.generate(
            prompts, pids, generator=_generator(dev, rnd), journal=journal,
            journal_keys=[f"r{rnd}-{b}" for b in range(len(prompts))],
        )
        dt = time.perf_counter() - t0
        print(  # dascheck: disable=DAS304 -- the CLI's round summary line on stdout, as main() printed it before
            f"round {rnd}: {dt * 1e3:8.1f} ms fwd={st.n_fwd:4d} "
            f"tokens={st.n_toks_emitted} accept/round="
            f"{st.acceptance_per_round:6.2f} device={dev}",
            flush=True,
        )
        _log_round(args, tel, rnd, "round %d done", rnd, ms=dt * 1e3,
                   fwd=st.n_fwd, accept_per_round=st.acceptance_per_round)
        if drain is not None and drain.draining:
            log.info("drain (%s): stopping after round %d", drain.reason,
                     rnd)
            break
        eng.begin_iteration(base_epoch + rnd + 1)


if __name__ == "__main__":
    main()
