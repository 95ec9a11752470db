"""The JAX-free modules the RL slice copies into the port (``data``,
``fault/{watchdog,drain}``, ``obs``, ``history/persist``) against their
originals: the same seeds give the same problems, rewards and shuffles;
the same telemetry calls give the same Prometheus text; the watchdog and
drain controller behave alike on a virtual clock; and a port engine's
history payload restores into a fresh engine."""

import numpy as np
import pytest

import repro.data as jdata
import repro.obs as jobs
import repro_torch.data as tdata
import repro_torch.obs as tobs
from repro.fault import VirtualClock as JVirtualClock
from repro.fault.drain import DrainController as JDrain
from repro.fault.watchdog import RolloutWatchdog as JWatchdog
from repro.fault.watchdog import StallError as JStallError
from repro_torch.fault import (
    DrainController,
    RolloutWatchdog,
    StallError,
    VirtualClock,
)


@pytest.mark.parametrize("family", ["PatternTask", "ArithmeticTask",
                                    "BracketTask"])
def test_tasks_and_rewards_match(family):
    jt, tt = getattr(jdata, family)(6), getattr(tdata, family)(6)
    rng = np.random.default_rng(0)
    for jp, tp in zip(jt.problems(), tt.problems()):
        assert (jp.pid, list(jp.prompt)) == (tp.pid, list(tp.prompt))
        want = tt.expected_response(tp)
        assert list(jt.expected_response(jp)) == list(want)
        for out in (want, [], list(rng.integers(0, 40, size=len(want)))):
            assert tt.reward(tp, out) == jt.reward(jp, out)
    assert tdata.TOKENIZER.vocab_size == jdata.TOKENIZER.vocab_size
    assert (tdata.EOS, tdata.PAD) == (jdata.EOS, jdata.PAD)


def test_loader_shuffles_match_and_seek():
    jl = jdata.PromptLoader(jdata.PatternTask(8), 3, seed=5)
    tl = tdata.PromptLoader(tdata.PatternTask(8), 3, seed=5)
    for ep in range(3):
        assert ([[p.pid for p in b] for b in jl.epoch_batches(ep)]
                == [[p.pid for p in b] for b in tl.epoch_batches(ep)])
    t2 = tdata.PromptLoader(tdata.PatternTask(8), 3, seed=5)
    t2.seek(3)
    assert ([[p.pid for p in b] for b in t2.epoch_batches(3)]
            == [[p.pid for p in b] for b in tl.epoch_batches(3)])


def test_telemetry_exports_match():
    out = []
    for obs in (jobs, tobs):
        tel = obs.Telemetry()
        tel.gauge("das_train_loss", "Last GRPO loss").set(1.5)
        tel.counter("das_rounds_total", "rounds").inc(3)
        tel.emit("train_step", step=1)
        out.append(tel.prometheus())
    assert out[0] == out[1]
    assert tobs.get_telemetry() is tobs.NULL and not tobs.NULL.enabled


def test_watchdog_and_drain_match():
    for Watchdog, Clock, Stall in ((JWatchdog, JVirtualClock, JStallError),
                                   (RolloutWatchdog, VirtualClock,
                                    StallError)):
        clock = Clock()
        wd = Watchdog(2.0, clock=clock)
        wd.arm()
        clock.advance(1.5)
        wd.check()
        wd.progress()
        clock.advance(2.5)
        with pytest.raises(Stall, match="no progress"):
            wd.check()
        assert wd.snapshot() == {"deadline_s": 2.0, "checks": 2, "stalls": 1}
    for Drain, Clock in ((JDrain, JVirtualClock), (DrainController,
                                                   VirtualClock)):
        clock = Clock()
        d = Drain(5.0, clock=clock)
        assert not d.draining and d.remaining() == float("inf")
        d.request("test")
        clock.advance(2.0)
        assert d.draining and not d.expired() and d.remaining() == 3.0
        clock.advance(3.0)
        assert d.expired()


def test_engine_history_round_trips_through_persist():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.history import persist
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config("qwen2-1.5b"))
    params = M.init_params(cfg, seed=0, device="cpu")

    def engine():
        return SpecEngine(params, cfg, EngineConfig(max_new_tokens=8),
                          drafter=SuffixDrafter(DrafterConfig(
                              scope="problem")), device="cpu")

    a = engine()
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    for ep in range(2):
        a.begin_iteration(ep)
        a.generate(prompts, ["p0", "p1"])
    state = persist.engine_state(a)
    b = engine()
    persist.restore_engine(b, state)
    assert b.epoch == a.epoch == 1
    assert b.drafter.store.n_rollouts == a.drafter.store.n_rollouts == 4
    assert b.drafter.store.state_dict() == a.drafter.store.state_dict()
    assert b.length_policy.state_dict() == a.length_policy.state_dict()
    b.begin_iteration(2)
    a.begin_iteration(2)
    assert a.generate(prompts, ["p0", "p1"])[0] == \
        b.generate(prompts, ["p0", "p1"])[0]
