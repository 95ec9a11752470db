"""Durability of the port's engine against the JAX engine's, on the CPU
(the dense weights and prompts of ``tests/test_torch_engine.py``, T = 0):

* ``serve`` with a write-ahead journal and a drain requested from the
  caller's side (a ``VirtualClock`` past the drain deadline, so the
  residents are preempted at once): the same requests finish, are
  preempted or stay queued on both sides, with the same partial outputs
  and the same journaled tokens per key; a fresh engine recovers the
  journal and resumes the rest (``resume_requests`` + ``serve``), and
  the outputs, the salvaged-token counter and the resumed journal equal
  JAX's and the uninterrupted run's;
* ``generate_continuous(resume=...)`` from the recovered sessions gives
  the uninterrupted outputs too;
* lock-step ``generate`` with a journal: the recovered sessions equal
  JAX's (tokens, prompts, limits, finished), fused and unfused;
* a stalled watchdog (``FaultPlan.stall_watchdog`` on a ``VirtualClock``)
  raises ``StallError`` out of ``generate`` and ``serve`` on both sides,
  at the same check.
"""

import jax
import pytest

import repro.fault as jfault
import repro.obs as jobs
import repro_torch.fault as tfault
import repro_torch.obs as tobs
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.drafter import SuffixDrafter as JSuffixDrafter
from repro.core.scheduler import Request as JRequest
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.core.spec_engine import SpecEngine as JSpecEngine
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.scheduler import Request
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from test_torch_engine import CFG, MAX_NEW, PIDS, _prompts
from test_torch_serve import _weights

ENG_KW = dict(max_new_tokens=24, max_draft=4, block_buckets=(0, 2, 4),
              eos_token=1)
DR_KW = dict(scope="problem", min_match=1, device_tail=16)
SLOTS = 2


@pytest.fixture(scope="module")
def weights():
    return _weights("dense")


def _engines(weights, tels=(None, None), **eng):
    jparams, cfg, params = weights
    kw = dict(ENG_KW, **eng)
    jeng = JSpecEngine(jparams, CFG, JEngineConfig(**kw),
                       drafter=JSuffixDrafter(JDrafterConfig(**DR_KW)),
                       telemetry=tels[0])
    teng = SpecEngine(params, cfg, EngineConfig(**kw),
                      drafter=SuffixDrafter(DrafterConfig(**DR_KW)),
                      telemetry=tels[1], device="cpu")
    return jeng, teng


def _requests(Req):
    return [Req(rid=i, problem_id=p, prompt=list(pr), max_new_tokens=m)
            for i, (p, pr, m) in enumerate(zip(PIDS, _prompts(), MAX_NEW))]


def _serve(eng, reqs, jax_side, **kw):
    if jax_side:
        kw["key"] = jax.random.key(1)
    return list(eng.serve(reqs, slots=SLOTS, **kw))


def _sessions(sess):
    return {k: (s.tokens, s.finished, s.prompt, s.max_new_tokens, s.status)
            for k, s in sess.items()}


def test_drain_journal_recover_resume_matches_jax(weights, tmp_path):
    base_j, base_t = _engines(weights)
    want = None
    for eng, jax_side, Req in ((base_j, True, JRequest),
                               (base_t, False, Request)):
        reqs = _requests(Req)
        _serve(eng, reqs, jax_side)
        outs = [r.output for r in reqs]
        assert want is None or outs == want
        want = outs
    sides = []
    for jax_side, f, Req, o in ((True, jfault, JRequest, jobs),
                                (False, tfault, Request, tobs)):
        clk = f.VirtualClock()
        path = str(tmp_path / f"{'j' if jax_side else 't'}.wal")
        jrnl = f.RolloutJournal(path)
        drain = f.DrainController(deadline_s=5.0, clock=clk)
        eng = _engines(weights)[0 if jax_side else 1]
        reqs = _requests(Req)
        served = []
        kw = dict(journal=jrnl, drain=drain, clock=clk)
        if jax_side:
            kw["key"] = jax.random.key(1)
        for fin in eng.serve(reqs, slots=SLOTS, **kw):
            served.append(fin.rid)
            if len(served) == 1:
                drain.request("test")  # stop admissions ...
                clk.advance(10.0)  # ... and pass the drain deadline
        jrnl.close()
        assert drain.expired()
        states = [r.state for r in reqs]
        partial = [list(r.output) for r in reqs]
        sess = f.RolloutJournal.recover(path)
        journaled = _sessions(sess)
        salvaged = sum(len(x.tokens) for x in sess.values()
                       if x.resumable)
        # a fresh engine recovers the journal and resumes the rest
        tel = o.Telemetry()
        eng2 = _engines(weights, tels=(tel, tel))[0 if jax_side else 1]
        rest = [r for r in reqs if r.state != "finished"]
        to_serve, pre_done = f.resume_requests(rest, sess)
        j2 = f.RolloutJournal(path)
        j2.adopt(sess)
        _serve(eng2, to_serve, jax_side, journal=j2)
        j2.close()
        sides.append(dict(
            served=served, states=states, partial=partial,
            journal=journaled, n_resume=len(to_serve),
            n_pre_done=len(pre_done), salvaged=salvaged,
            resumed=tel.registry.value("das_resumed_tokens_total"),
            final=[r.output for r in reqs],
            after=_sessions(f.RolloutJournal.recover(path)),
        ))
    j, t = sides
    assert t == j
    assert "finished" in t["states"] and (
        "preempted" in t["states"] or "queued" in t["states"])
    assert t["salvaged"] > 0 and t["resumed"] == t["salvaged"]
    assert t["final"] == want
    assert all(s[1] for s in t["after"].values()), "every session finished"
    for r_out, p in zip(t["final"], t["partial"]):
        assert r_out[: len(p)] == p


def test_generate_continuous_resume_from_recovered_sessions(weights,
                                                            tmp_path):
    _, teng = _engines(weights)
    want, _ = teng.generate_continuous(_prompts(), PIDS, slots=SLOTS,
                                       max_new_tokens=MAX_NEW)
    path = str(tmp_path / "c.wal")
    j = tfault.RolloutJournal(path)
    keys = [f"k{i}" for i in range(len(PIDS))]
    for k, p, pid, mn, o in zip(keys, _prompts(), PIDS, MAX_NEW, want):
        j.begin(k, p, problem_id=pid, max_new_tokens=mn)
        j.note(k, o[: len(o) // 3])
    j.commit()
    j.close()
    sess = tfault.RolloutJournal.recover(path)
    tel = tobs.Telemetry()
    _, eng = _engines(weights, tels=(None, tel))
    got, _ = eng.generate_continuous(_prompts(), PIDS, slots=SLOTS,
                                     max_new_tokens=MAX_NEW,
                                     journal_keys=keys, resume=sess)
    assert got == want
    assert tel.registry.value("das_resumed_tokens_total") == \
        sum(len(o) // 3 for o in want if len(o) // 3)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_generate_with_journal_matches_jax(weights, tmp_path, fuse):
    jeng, teng = _engines(weights, fuse_rounds=fuse)
    keys = [f"{p}#{i}" for i, p in enumerate(PIDS)]
    got = []
    for eng, f, name in ((jeng, jfault, "j"), (teng, tfault, "t")):
        path = str(tmp_path / f"{name}.wal")
        j = f.RolloutJournal(path, fsync_every=2)
        kw = dict(key=jax.random.key(0)) if name == "j" else {}
        outs, st = eng.generate(_prompts(), PIDS, max_new_tokens=MAX_NEW,
                                journal=j, journal_keys=keys, **kw)
        j.close()
        sess = _sessions(f.RolloutJournal.recover(path))
        assert [sess[k][0] for k in keys] == outs
        got.append((outs, sess, st.n_rounds))
    assert got[0] == got[1]


@pytest.mark.parametrize("path", ["generate", "serve"])
def test_stalled_watchdog_raises_alike(weights, path):
    jeng, teng = _engines(weights)
    fired = []
    for eng, f in ((jeng, jfault), (teng, tfault)):
        plan = f.FaultPlan(seed=0)
        wd = plan.stall_watchdog(
            f.RolloutWatchdog(30.0, clock=f.VirtualClock()), at_check=3)
        kw = dict(key=jax.random.key(0)) if f is jfault else {}
        with pytest.raises(f.StallError, match="no progress"):
            if path == "generate":
                eng.generate(_prompts(), PIDS, max_new_tokens=MAX_NEW,
                             watchdog=wd, **kw)
            else:
                list(eng.serve(_requests(JRequest if f is jfault
                                         else Request), slots=SLOTS,
                               watchdog=wd, **kw))
        fired.append((plan.fired, wd.checks, wd.stalls))
    assert fired[0] == fired[1] and fired[1][2] == 1
