"""Telemetry of the port's engine against the JAX engine's, on the CPU.

The smoke Qwen3 variant (``smoke_variant(qwen3-8b)``: 2 layers, width
256, vocab 1024) gets the JAX ``init_params`` weights through numpy and
serves the same requests continuously (fewer slots than requests, two
epochs over the same problems, so the second drafts) with one
``obs.Telemetry`` and its flight recorder on each side, at T = 0:

* outputs token-identical, and the engine's registry the same: rounds,
  forwards, proposed/drafted/accepted/emitted tokens, the salvage
  counter, the accepted-tokens histogram's count and sum per length
  class, the host-time histogram's count, the preemption counter;
* each request's flight-event kinds in the same order (trace IDs differ
  between runs, so events are matched by request);
* the Prometheus text carries ``das_rounds_total`` and the token
  counters equal to the ``RolloutStats``;
* ``n_d2h``/``n_h2d`` equal with telemetry on and off, lock-step and
  continuous: observability adds no host/device crossing;
* the lock-step path's spans and flight events come out too, and a
  trace export validates.
"""

import dataclasses

import jax
import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from conftest import make_params
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.drafter import SuffixDrafter as JSuffixDrafter
from repro.core.scheduler import Request as JRequest
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.core.spec_engine import SpecEngine as JSpecEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.scheduler import Request
from repro_torch.core.spec_engine import EngineConfig, RolloutStats, SpecEngine
from repro_torch.models.convert import params_from_numpy
from test_torch_engine import MIN_GAP, _min_top2_gap

JCFG = jax_smoke_variant(jax_get_config("qwen3-8b"))
CFG = ModelConfig(**dataclasses.asdict(JCFG))
ENG_KW = dict(max_new_tokens=24, max_draft=4, block_buckets=(0, 2, 4),
              eos_token=1)
DR_KW = dict(scope="problem", min_match=1, device_tail=16)
PIDS = ["a", "b", "a", "c", "b", "a"]
MAX_NEW = [14, 7, 12, 9, 6, 13]
SLOTS = 3

ENGINE_COUNTERS = (
    "das_rounds_total", "das_fwd_total", "das_tokens_proposed_total",
    "das_tokens_drafted_total", "das_tokens_accepted_total",
    "das_tokens_emitted_total", "das_resumed_tokens_total",
)


@pytest.fixture(scope="module")
def weights():
    jparams = make_params(JCFG, seed=2)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    return jparams, params


def _prompts():
    rng = np.random.default_rng(3)
    base = {pid: [int(t) for t in rng.integers(2, JCFG.vocab_size, size=n)]
            for pid, n in (("a", 6), ("b", 9), ("c", 4))}
    return [base[p] for p in PIDS]


def _requests(Req):
    return [Req(rid=i, problem_id=p, prompt=list(pr), max_new_tokens=m)
            for i, (p, pr, m) in enumerate(zip(PIDS, _prompts(), MAX_NEW))]


def _jax_engine(jparams, tel):
    return JSpecEngine(jparams, JCFG, JEngineConfig(**ENG_KW),
                       drafter=JSuffixDrafter(JDrafterConfig(**DR_KW)),
                       telemetry=tel)


def _port_engine(params, tel=None, **eng):
    return SpecEngine(params, CFG, EngineConfig(**dict(ENG_KW, **eng)),
                      drafter=SuffixDrafter(DrafterConfig(**DR_KW)),
                      telemetry=tel, device="cpu")


def _registry_view(reg):
    out = {n: reg.value(n) for n in ENGINE_COUNTERS}
    for cls in ("short", "medium", "long"):
        h = reg.get("das_accepted_tokens", (("length_class", cls),))
        out[f"accepted_{cls}"] = (h.count, h.sum, list(h.counts))
    out["round_host_count"] = reg.get("das_round_host_seconds").count
    return out


def _kinds_by_rid(tel, reqs):
    fr = tel.flight
    return {r.rid: [e["kind"] for e in fr.events(trace=r.trace)]
            for r in reqs}


def test_serve_registry_and_flight_events_match_jax(weights):
    jparams, params = weights
    tels = []
    for o in (jobs, tobs):
        tel = o.Telemetry()
        tel.attach_flight(worker="w0")
        tels.append(tel)
    jeng = _jax_engine(jparams, tels[0])
    teng = _port_engine(params, tels[1])
    kinds = [{}, {}]
    total_accepted = 0
    for epoch in range(2):
        jeng.begin_iteration(epoch)
        teng.begin_iteration(epoch)
        jreqs, treqs = _requests(JRequest), _requests(Request)
        jst, tst = RolloutStats(), RolloutStats()
        list(jeng.serve(jreqs, slots=SLOTS, key=jax.random.key(0),
                        stats=jst))
        list(teng.serve(treqs, slots=SLOTS, stats=tst))
        jouts = [r.output for r in jreqs]
        assert [r.output for r in treqs] == jouts
        assert _min_top2_gap(jparams, _prompts(), jouts, JCFG) > MIN_GAP
        assert (tst.n_rounds, tst.n_drafted, tst.n_accepted) == (
            jst.n_rounds, jst.n_drafted, jst.n_accepted)
        total_accepted += tst.n_accepted
        for i, (tel, reqs) in enumerate(zip(tels, (jreqs, treqs))):
            for rid, ks in _kinds_by_rid(tel, reqs).items():
                kinds[i][(epoch, rid)] = ks
    assert total_accepted > 0, "the second epoch must accept drafts"
    want = _registry_view(tels[0].registry)
    assert _registry_view(tels[1].registry) == want
    assert want["das_rounds_total"] > 0 and want["round_host_count"] > 0
    assert sum(want[f"accepted_{c}"][0] for c in ("short", "medium",
                                                  "long")) > 0
    assert kinds[1] == kinds[0]
    assert all(ks[0] == "queued" and ks[-1] == "finish" and "round" in ks
               for ks in kinds[1].values())
    # the Prometheus text carries the engine counters
    text = tels[1].prometheus()
    for name in ("das_rounds_total", "das_tokens_drafted_total",
                 "das_tokens_accepted_total"):
        assert f"{name} {want[name]:g}" in text or \
            f"{name} {float(want[name])}" in text, name
    # spans of the continuous loop, and a valid trace export
    names = {s.name for s in tels[1].tracer.recent(4096)}
    assert {"serve_round", "consume", "verify_dispatch", "prefill",
            "budget_solve"} <= names
    doc = tobs.to_chrome_trace([{
        "name": "w0", "spans": [s.to_dict()
                                for s in tels[1].tracer.recent(4096)],
        "flight": tels[1].flight.events(),
        "perf_offset": tels[1].flight.perf_offset}])
    assert tobs.validate_chrome_trace(doc) == []
    rep = tobs.attribute(tels[1].flight.events(),
                         [s.to_dict() for s in tels[1].tracer.recent(4096)])
    assert rep["n_rollouts"] == 2 * len(PIDS)


@pytest.mark.parametrize("mode", ["continuous", "lockstep", "unfused"])
def test_telemetry_adds_no_transfer(weights, mode):
    _, params = weights
    runs = []
    for on in (False, True):
        tel = None
        if on:
            tel = tobs.Telemetry()
            tel.attach_flight(worker="w0")
        eng = _port_engine(params, tel,
                           fuse_rounds="off" if mode == "unfused" else "auto")
        st = []
        for epoch in range(2):
            eng.begin_iteration(epoch)
            if mode == "continuous":
                outs, s = eng.generate_continuous(
                    _prompts(), PIDS, slots=SLOTS, max_new_tokens=MAX_NEW)
            else:
                outs, s = eng.generate(_prompts(), PIDS,
                                       max_new_tokens=MAX_NEW)
            st.append((outs, s.n_d2h, s.n_h2d, s.n_rounds, s.n_accepted))
        runs.append(st)
        if on:
            reg = tel.registry
            assert reg.value("das_rounds_total") == sum(x[3] for x in st)
            assert reg.value("das_tokens_accepted_total") == \
                sum(x[4] for x in st)
            assert reg.value("das_d2h_transfers_total") == \
                sum(x[1] for x in st)
            if mode != "continuous":
                names = {s.name for s in tel.tracer.recent(4096)}
                assert {"round", "budget_solve", "accept_emit"} <= names
                kinds = {e["kind"] for e in tel.flight.events()}
                assert {"admit", "round", "finish"} <= kinds
    assert runs[0] == runs[1]
