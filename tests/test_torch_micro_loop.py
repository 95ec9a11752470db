"""The port's R-round fused micro-loop (``fused_round.fused_micro``,
``EngineConfig(micro_rounds=R)``) against the JAX engine's
``lax.while_loop`` one, at T = 0, same weights (JAX ``init_params``
through numpy):

* R = 4 on both sides: equal tokens, equal ``n_rounds``, and an equal
  ``n_done`` (the rounds that ran) at every dispatch; against the port's
  R = 1: equal tokens and rounds, strictly fewer ``n_d2h``, and a
  dispatch that ran more than one round. Two epochs of
  ``tests/test_fused_round.py``'s traffic (in its epoch 0 a row finishes
  in each of the first four rounds, then dispatches run 4, 2 and 3
  rounds; in its epoch 1 a row finishes in every round, so no sync is
  saved there: the reason that file's micro-loop test counts 10 syncs
  for both R), and a batch of equal
  limits on fresh history with an EOS id the model never emits (no row
  drafts or stops early), where every dispatch but the last runs R
  rounds. For the dense decoder and the hybrid (RG-LRU + local attention,
  whose verify rounds commit staged recurrent states).
* Every round enqueued past the loop's exit leaves the cache and the
  ``RoundState`` bit-identical (the attention ring's trash slot, which
  nothing reads, excepted).
* At T > 0 the same generator seed gives the same tokens.
* ``EngineConfig(micro_rounds=0)`` raises.

The per-dispatch counts are printed (``pytest -s``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.drafter import SuffixDrafter as JSuffixDrafter
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.core.spec_engine import SpecEngine as JSpecEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.core import fused_round as FR
from repro_torch.core import spec_engine as SE
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.models.convert import params_from_numpy

# tests/test_fused_round.py's model and traffic
DENSE = JModelConfig(
    name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=64, vocab_pad_multiple=8,
    dtype="float32",
)
PROMPTS = [
    [2, 3, 4, 5], [7, 8], [9, 10, 11, 12, 13, 14], [5, 6],
    [3, 3, 3], [4, 4, 9, 2], [2, 2], [11, 12, 13],
]
PIDS = ["a", "b", "c", "d", "e", "a", "b", "c"]
LIMITS = [14, 9, 22, 7, 5, 11, 3, 18]
EQUAL = [13] * 8
# RecurrentGemma-9B's smoke variant (rglru, rglru, local_attn), one K
# bucket as in tests/test_torch_engine.py
HYBRID = jax_smoke_variant(jax_get_config("recurrentgemma-9b"))
FAMILIES = {"dense": (DENSE, 0, (0, 2, 4)), "hybrid": (HYBRID, 4, (4,))}
R = 4


def _port_params(jparams, jcfg):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")


def _eng_kw(buckets, micro_rounds, temperature=0.0, eos_token=1):
    return dict(max_new_tokens=24, max_draft=4, block_buckets=buckets,
                eos_token=eos_token, temperature=temperature,
                fuse_rounds="on", micro_rounds=micro_rounds)


DR_KW = dict(scope="problem", min_match=1, window_size=16)


def _port_engine(cfg, params, buckets, micro_rounds, temperature=0.0,
                 eos_token=1):
    return SpecEngine(params, cfg,
                      EngineConfig(**_eng_kw(buckets, micro_rounds,
                                             temperature, eos_token)),
                      drafter=SuffixDrafter(DrafterConfig(**DR_KW)),
                      device="cpu")


class _PortDispatches:
    """Records ``n_done`` of every port dispatch (read from the result it
    returns, which the engine downloads anyway)."""

    def __init__(self, monkeypatch):
        self.n_done = []
        real = SE.fused_micro

        def spy(*a, **kw):
            flat = real(*a, **kw)
            self.n_done.append(int(flat[-1]))
            return flat

        monkeypatch.setattr(SE, "fused_micro", spy)


def _jax_dispatches(jeng):
    """Records ``n_done`` of every JAX micro-loop dispatch."""
    n_done = []
    real = jeng._get_fused

    def get(K, Rr):
        fn = real(K, Rr)

        def run(*a):
            out = fn(*a)
            n_done.append(int(out[3]))
            return out

        return run

    jeng._get_fused = get
    return n_done


def _epochs(eng, traffic, jax_key=None):
    """Per epoch (outputs, stats); ``traffic`` is a list of
    (prompts, pids, limits), one epoch each, on one engine."""
    runs = []
    for ep, (prompts, pids, limits) in enumerate(traffic):
        eng.begin_iteration(ep)
        kw = {} if jax_key is None else dict(key=jax.random.key(jax_key + ep))
        runs.append(eng.generate(prompts, pids, max_new_tokens=limits, **kw))
    return runs


# name: (epochs of (prompts, pids, limits), EOS id or None for one past
# the vocabulary)
TRAFFIC = {
    "fused_round_workload": ([(PROMPTS, PIDS, LIMITS)] * 2, 1),
    "equal_limits": ([(PROMPTS, [f"q{b}" for b in range(8)], EQUAL)], None),
}


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_micro_loop_matches_jax_and_r1(family, traffic, monkeypatch):
    jcfg, seed, buckets = FAMILIES[family]
    epochs, eos = TRAFFIC[traffic]
    eos = jcfg.vocab_size if eos is None else eos
    jparams = make_params(jcfg, seed=seed)
    cfg, params = _port_params(jparams, jcfg)
    jeng = JSpecEngine(jparams, jcfg,
                       JEngineConfig(**_eng_kw(buckets, R, eos_token=eos)),
                       drafter=JSuffixDrafter(JDrafterConfig(**DR_KW)))
    jdone = _jax_dispatches(jeng)
    jruns = _epochs(jeng, epochs, jax_key=5)
    r1 = _epochs(_port_engine(cfg, params, buckets, 1, eos_token=eos), epochs)
    spy = _PortDispatches(monkeypatch)
    r4 = _epochs(_port_engine(cfg, params, buckets, R, eos_token=eos), epochs)
    print(f"\n{family} {traffic}: n_done per dispatch, port R={R} "
          f"{spy.n_done}, JAX {jdone}; n_d2h R={R} "
          f"{sum(s.n_d2h for _, s in r4)}, R=1 {sum(s.n_d2h for _, s in r1)}")
    for (jo, js), (o1, s1), (o4, s4) in zip(jruns, r1, r4):
        assert o4 == jo and o1 == jo
        assert s4.n_rounds == js.n_rounds == s1.n_rounds
        assert (s4.n_drafted, s4.n_accepted) == (js.n_drafted, js.n_accepted)
        assert s4.n_rounds + s4.n_idle_rounds == R * s4.n_dispatches
        assert s1.n_idle_rounds == 0 and s1.n_dispatches == s1.n_rounds
    assert spy.n_done == jdone
    assert max(spy.n_done) > 1, "no dispatch ran more than one round"
    assert sum(s.n_d2h for _, s in r4) < sum(s.n_d2h for _, s in r1)
    if traffic == "equal_limits":  # every dispatch but the last runs R
        assert all(n == R for n in spy.n_done[:-1])


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_rounds_past_the_exit_change_nothing(family, monkeypatch):
    """Every round enqueued after the loop's exit (``go`` False) leaves
    every cache tensor and the ``RoundState`` bit-identical; the ring's
    trash slot S takes the dead block's K/V and keeps its position tag
    -1."""
    jcfg, seed, buckets = FAMILIES[family]
    cfg, params = _port_params(make_params(jcfg, seed=seed), jcfg)
    real = FR.fused_round
    checked = []

    def snapshot(cache, state):
        out = [t.clone() for t in (state.head, state.tails, state.active,
                                   state.emitted, state.max_new,
                                   cache.lengths)]
        for layer in cache.layers:
            if isinstance(layer, dict):
                out += [layer[k].clone() for k in sorted(layer)]
            else:
                k, v, pos = layer
                out += [k[:, :-1].clone(), v[:, :-1].clone(), pos.clone()]
        return out

    def spy(params_, cfg_, forest, cache, state, *a, go=None, **kw):
        if go is None or bool(go):
            return real(params_, cfg_, forest, cache, state, *a, go=go, **kw)
        before = snapshot(cache, state)
        out = real(params_, cfg_, forest, cache, state, *a, go=go, **kw)
        after = snapshot(cache, state)
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        for layer in cache.layers:
            if not isinstance(layer, dict):
                assert bool((layer[2][:, -1] == -1).all())
        assert not bool(out[:, -3:].any()), "a dead round's bookkeeping"
        checked.append(1)
        return out

    monkeypatch.setattr(FR, "fused_round", spy)
    eng = _port_engine(cfg, params, buckets, R)
    _epochs(eng, TRAFFIC["fused_round_workload"][0][:1])
    assert checked, "no round ran past the loop's exit"


def test_micro_loop_same_seed_same_tokens_at_t_gt_0():
    jcfg, seed, buckets = FAMILIES["dense"]
    cfg, params = _port_params(make_params(jcfg, seed=seed), jcfg)
    outs = []
    for _ in range(2):
        eng = _port_engine(cfg, params, buckets, R, temperature=0.8)
        eng.begin_iteration(0)
        o, st = eng.generate(PROMPTS, PIDS, max_new_tokens=LIMITS,
                             generator=torch.Generator().manual_seed(3))
        outs.append(o)
        assert st.n_idle_rounds > 0
    assert outs[0] == outs[1]
    assert sum(map(len, outs[0])) > 0


def test_micro_rounds_zero_raises():
    with pytest.raises(ValueError, match="micro_rounds"):
        EngineConfig(micro_rounds=0)
    assert EngineConfig(micro_rounds=4).micro_rounds == 4
