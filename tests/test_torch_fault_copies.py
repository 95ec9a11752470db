"""The JAX-free modules the telemetry-and-durability slice copies into the
port (``fault/{journal,health,supervisor,inject}``, ``history/{wire,
service,client}``, ``obs/{perfetto,attrib}``) against their originals:

* a journal written by either package is recovered by the other, and the
  same calls give byte-identical files; a torn tail truncates and a
  corrupt record quarantines alike;
* ``history.wire`` frames are byte-identical for the same messages, and
  packs cross the wire both ways;
* ``BackoffPolicy`` and the shard health machine step alike on a virtual
  clock, and one seeded ``FaultPlan`` fires the same faults;
* ``ShardSupervisor.poll`` restarts a killed in-process shard on both
  sides, and a client of either package syncs from a service of either;
* ``perfetto.to_chrome_trace`` and ``attrib.attribute`` give equal
  documents for the same recording.

Every socket test sets an ``rpc_timeout`` and stops its service in a
``finally``, so a hung socket cannot stall the suite.
"""

import json
import random
import socket
import time

import numpy as np
import pytest

import repro.fault as jfault
import repro.obs as jobs
import repro_torch.fault as tfault
import repro_torch.obs as tobs
from repro.history import wire as jwire
from repro.history.client import HistoryClient as JClient
from repro.history.service import HistoryService as JService
from repro_torch.history import wire as twire
from repro_torch.history.client import HistoryClient as TClient
from repro_torch.history.service import HistoryService as TService

SIDES = [("jax", jfault), ("port", tfault)]


def _journal_calls(j):
    j.begin("a", [5, 6, 7], problem_id="p0", max_new_tokens=8, trace="t-a")
    j.begin("b", [9, 10], problem_id=3, max_new_tokens=6)
    j.note("a", [11])
    j.note("b", [12, 13])
    j.commit()
    j.note("a", [14, 15, 16])
    j.finish("b", n_emitted=2)
    j.commit()
    j.note("a", [17])
    j.begin("c", [1, 2], problem_id="p1", max_new_tokens=4, resume=True)
    j.note("c", [3])
    j.finish("c", status="cancelled", n_emitted=1)
    j.commit()
    j.close()


def _sessions(sess):
    return {k: (s.prompt, s.tokens, s.finished, s.status, s.problem_id,
                s.max_new_tokens, s.trace, s.resumable)
            for k, s in sess.items()}


def test_journal_files_byte_identical_and_cross_recovered(tmp_path):
    paths = {}
    for name, f in SIDES:
        paths[name] = str(tmp_path / f"{name}.wal")
        _journal_calls(f.RolloutJournal(paths[name], fsync_every=2))
    data = {n: open(p, "rb").read() for n, p in paths.items()}
    assert data["jax"] == data["port"] and len(data["jax"]) > 0
    want = _sessions(jfault.RolloutJournal.recover(paths["jax"]))
    assert want["a"][1] == [11, 14, 15, 16, 17] and want["b"][2]
    # each side's reader on the other side's file
    assert _sessions(tfault.RolloutJournal.recover(paths["jax"])) == want
    assert _sessions(jfault.RolloutJournal.recover(paths["port"])) == want
    # resume_requests pairs the recovered salvage with requests alike
    from repro.core.scheduler import Request as JRequest
    from repro_torch.core.scheduler import Request as TRequest

    got = []
    for (name, f), Req in zip(SIDES, (JRequest, TRequest)):
        reqs = [Req(rid=i, problem_id="p0", prompt=[5, 6, 7],
                    max_new_tokens=8, journal_key=k)
                for i, k in enumerate(("a", "b", "z"))]
        sess = f.RolloutJournal.recover(paths[name])
        to_serve, done = f.resume_requests(reqs, sess)
        got.append(([(r.rid, r.resume_tokens) for r in to_serve],
                     [(r.rid, r.output, r.state) for r in done]))
    assert got[0] == got[1]


def test_torn_tail_and_corruption_quarantine_alike(tmp_path):
    for name, f in SIDES:
        p = str(tmp_path / f"{name}.wal")
        _journal_calls(f.RolloutJournal(p))
        f.tear_journal_tail(p, drop_bytes=3)
    a = _sessions(jfault.RolloutJournal.recover(str(tmp_path / "port.wal")))
    b = _sessions(tfault.RolloutJournal.recover(str(tmp_path / "jax.wal")))
    assert a == b
    assert (tmp_path / "jax.wal").read_bytes() == \
        (tmp_path / "port.wal").read_bytes(), "torn tails truncate alike"
    for name, f in SIDES:
        p = tmp_path / f"{name}-bad.wal"
        _journal_calls(f.RolloutJournal(str(p)))
        raw = bytearray(p.read_bytes())
        raw[12] ^= 0xFF  # inside the first record, not the tail
        p.write_bytes(bytes(raw))
        with pytest.raises(f.JournalCorruptError):
            f.RolloutJournal.recover(str(p))
        assert (tmp_path / f"{name}-bad.wal.corrupt").exists()
        assert not p.exists()


def _pack(seed=0):
    from repro.core.suffix_tree import SuffixTree as JTree

    rng = np.random.default_rng(seed)
    t = JTree(epoch_decay=0.9)
    for d in range(3):
        t.add_document([int(x) for x in rng.integers(0, 8, size=14)],
                       epoch=d)
    return t.pack()


def test_wire_frames_byte_identical():
    pk = _pack()
    msgs = [
        {"op": "sync", "cursor": {"3": 7}, "origin": "w0"},
        {"op": "publish", "rollouts": [["p0", [1, 2, 3], 0, 3, "t-1"]],
         "arr": np.arange(12, dtype=np.int32).reshape(3, 4),
         "f": np.linspace(0, 1, 5, dtype=np.float32), "b": b"\x00\x01"},
        {"ok": True, "packs": [jwire.pack_to_wire(pk)]},
    ]
    for m in msgs:
        a, b = jwire.dumps(m), twire.dumps(m)
        assert a == b
        back = twire.loads(a)
        assert jwire.dumps(back) == a
    # a pack crosses the wire both ways and comes back field for field
    tpk = twire.wire_to_pack(twire.loads(jwire.dumps(jwire.pack_to_wire(pk))))
    for field in ("corpus", "edges_key", "edges_child", "node_start",
                  "node_end", "suffix_link", "best_child"):
        if hasattr(pk, field):
            np.testing.assert_array_equal(getattr(tpk, field),
                                          getattr(pk, field))
    assert jwire.dumps(jwire.pack_to_wire(pk)) == \
        twire.dumps(twire.pack_to_wire(tpk))
    # framed on a socket pair: the same bytes, and each side reads the
    # other's frame
    for send, recv in ((jwire.send_msg, twire.recv_msg),
                       (twire.send_msg, jwire.recv_msg)):
        s1, s2 = socket.socketpair()
        try:
            s2.settimeout(5.0)
            send(s1, msgs[0])
            assert recv(s2) == msgs[0]
        finally:
            s1.close()
            s2.close()


def test_backoff_and_health_step_alike():
    trails = []
    for _, f in SIDES:
        pol = f.BackoffPolicy(base_s=0.1, max_s=1.0, factor=2.0, jitter=0.25)
        delays = [pol.delay(n, random.Random(7)) for n in range(1, 10)]
        clk = f.VirtualClock()
        h = f.ShardHealth(0, clock=clk, policy=pol, suspect_after=2)
        trail = [h.state, h.should_attempt()]
        for step in ("fail", "fail", "try", "adv", "try", "fail", "adv",
                     "ok", "sync", "fail", "fail", "adv", "ok", "fail"):
            if step == "fail":
                trail.append(h.record_failure())
            elif step == "ok":
                trail.append(h.record_success())
            elif step == "sync":
                h.resynced()
                trail.append(h.state)
            elif step == "adv":
                clk.advance(h.retry_in() + 1e-6)
            else:
                trail.append((h.should_attempt(), round(h.retry_in(), 9)))
            trail.append(h.state)
        trails.append((delays, trail, h.snapshot()))
    assert trails[0] == trails[1]
    assert tfault.DOWN in trails[1][1] and tfault.RESYNCING in trails[1][1]


def test_fault_plan_fires_the_same_faults():
    fired = []
    for _, f in SIDES:
        plan = (f.FaultPlan(seed=3)
                .kill_shard(0, op="publish", at=2)
                .truncate_frame(1, op="sync", at=1)
                .delay_frame(1, op="sync", at=3, delay_s=0.05)
                .crash_journal(at=2, mode="raise"))
        hooks = [plan.server_hook(0), plan.server_hook(1)]
        actions = [hooks[s](op) for s, op in
                   [(0, "publish"), (1, "sync"), (0, "publish"),
                    (1, "sync"), (1, "sync"), (0, "sync")]]
        jh = plan.journal_hook()
        jh(1)
        with pytest.raises(f.JournalCrashError):
            jh(2)
        clk = f.VirtualClock()
        wd = plan.stall_watchdog(f.RolloutWatchdog(5.0, clock=clk),
                                 at_check=2)
        wd.arm()
        wd.check()
        with pytest.raises(f.StallError):
            wd.check()
        fired.append((actions, plan.fired, plan.pending()))
    assert fired[0] == fired[1]
    assert len(fired[1][1]) == 5 and fired[1][2] == 0


def _service_round_trip(Service, Client, f, other_client):
    """Spawn 2 in-process shards, publish through a client, kill a shard,
    let the supervisor restart it, and read the pack back through the
    client of the other package."""
    rng = np.random.default_rng(5)
    pol = f.BackoffPolicy(base_s=0.01, max_s=0.05, jitter=0.0)
    svc = Service.spawn_in_process(2, window_size=8)
    sup = f.ShardSupervisor(svc, seed=0, policy=pol)
    clients = []
    try:
        c = Client(svc.book, worker_id="w0", rpc_timeout=2.0, backoff=pol)
        clients.append(c)
        doc = [int(t) for t in rng.integers(0, 8, size=14)]
        c.publish_rollout("p0", doc, 0, response_len=len(doc))
        assert c.flush(timeout=5.0)
        c.sync()
        before = c.pack_for("p0")
        assert before is not None
        i = c.shard_of("p0")
        v0 = svc.book.version
        svc.servers[i].stop()
        svc.servers[i].stopped.wait(timeout=5.0)
        assert not svc.shard_alive(i)
        restarted = sup.poll(force=True)
        assert restarted == [i] and svc.shard_alive(i)
        assert svc.book.version > v0
        # The first sync may land on the killed shard's old connection:
        # when the server closed it before its thread was back in recv
        # (a loaded host), the kernel sent a FIN, the client reads EOF,
        # which ``_rpc`` counts as a failure with no reconnect, and
        # ``sync`` skips the shard. The next sync dials the republished
        # address. Wait for that condition, not for a time.
        deadline = time.monotonic() + 10.0
        while c.stats["shard_restarts"] == 0 and time.monotonic() < deadline:
            c.sync()
        assert c.stats["shard_restarts"] == 1
        # the other package's client dials the restarted addresses
        o = other_client(list(svc.addresses), worker_id="w1",
                         rpc_timeout=2.0)
        clients.append(o)
        o.sync()
        after = o.pack_for("p0")
        return (restarted, sup.stats["restarts"],
                [np.asarray(a).tolist() for a in (before.corpus,
                                                  after.corpus)])
    finally:
        for cl in clients:
            cl.close(flush_timeout=0.5)
        sup.stop()
        svc.stop()


def test_supervisor_restarts_killed_shard_alike():
    a = _service_round_trip(JService, JClient, jfault, TClient)
    b = _service_round_trip(TService, TClient, tfault, JClient)
    assert a == b
    assert a[2][0] == a[2][1], "the restored shard serves the same pack"


def _synthetic_fleet(t0=1000.0):
    """Two workers, four rollouts; the last is the long tail and moves
    to the other worker (a handoff, then a resume)."""
    evs, seq = [], iter(range(1000))

    def ev(worker, trace, kind, ts, dur=0.0, **kw):
        e = {"worker": worker, "shard": None, "seq": next(seq),
             "trace": trace, "kind": kind, "ts": ts, "dur": dur}
        e.update(kw)
        return e

    for i, (w, length, n_rounds) in enumerate(
            [("w0", 4, 2), ("w0", 6, 3), ("w1", 8, 4), ("w1", 40, 12)]):
        tr = f"t-{i}"
        evs.append(ev(w, tr, "queued", t0))
        evs.append(ev(w, tr, "admit", t0 + 0.05, dur=0.02, slot=i))
        for r in range(n_rounds):
            evs.append(ev(w, tr, "round", t0 + 0.1 + 0.1 * r, dur=0.08,
                          round=r, accepted=length // n_rounds,
                          drafted=4 + (2 if length > 10 else 0)))
        if i == 3:
            evs.append(ev("w1", tr, "handoff", t0 + 1.35, from_worker=1,
                          to_worker=0))
            evs.append(ev("w0", tr, "resume", t0 + 1.5, dur=0.03, slot=0))
        end = t0 + 0.1 + 0.1 * n_rounds + (2.2 if i == 3 else 0.0)
        evs.append(ev(w if i != 3 else "w0", tr, "finish", end,
                      status="finished", emitted=length))
    spans = [
        {"name": "fused_dispatch", "parent": "round", "depth": 1,
         "t0": 1.0, "dur_s": 0.6},
        {"name": "budget_solve", "parent": "round", "depth": 1,
         "t0": 2.0, "dur_s": 0.2},
        {"name": "prefill", "parent": None, "depth": 0, "t0": 0.0,
         "dur_s": 0.3},
        {"name": "cache_commit", "parent": "prefill", "depth": 1,
         "t0": 0.1, "dur_s": 0.2},
    ]
    return evs, spans


def test_perfetto_and_attribution_documents_equal():
    evs, spans = _synthetic_fleet()
    workers = [
        {"name": "w0", "spans": spans,
         "flight": [e for e in evs if e["worker"] == "w0"],
         "perf_offset": 999.0},
        {"name": "w1", "spans": [],
         "flight": [e for e in evs if e["worker"] == "w1"],
         "perf_offset": 999.0},
    ]
    docs = [o.to_chrome_trace(json.loads(json.dumps(workers)))
            for o in (jobs, tobs)]
    assert docs[0] == docs[1] and docs[0]["traceEvents"]
    assert tobs.validate_chrome_trace(docs[1]) == []
    assert jobs.validate_chrome_trace(docs[1]) == []
    reps = [o.attribute(evs, spans) for o in (jobs, tobs)]
    assert json.dumps(reps[0], sort_keys=True, default=str) == \
        json.dumps(reps[1], sort_keys=True, default=str)
    assert jobs.render_report(reps[0]) == tobs.render_report(reps[1])
