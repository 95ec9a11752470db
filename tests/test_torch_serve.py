"""Continuous serving (``SpecEngine.serve`` / ``generate_continuous``) of
the port against the JAX package.

* ``copy_cache_rows``: the same caches (JAX prefills, through numpy) and
  the same padded slot list through both packages; every cache array must
  be equal afterwards (a pure copy: exact).
* ``sample_token_rows``: fed the Gumbel noise of JAX's per-row keys, the
  port draws JAX's tokens.
* ``generate_continuous`` at T = 0 with fewer slots than requests, for the
  flat and the chunked forest layouts, fused and unfused rounds, two
  epochs over the same problems: token-identical to JAX's
  ``generate_continuous`` (equal makespan, drafted, accepted and per-row
  rounds) and to the port's lock-step ``generate``.
* ``serve`` recycles slots on EOS and on token limits, and a preempted
  request resumes token-identically by prefix re-prefill.

Weights and prompts are those of ``tests/test_torch_engine.py``, whose
seeds keep JAX's top-2 logit gap above 1e-3 on every emitted position.
The hybrid cases (RecurrentGemma's smoke variant: RG-LRU + local
attention) run ``copy_cache_rows`` over its ``{"h", "conv"}`` layer
caches, ``generate_continuous`` (chunked, fused, one K bucket) against
JAX, and a preempted request's resume by re-prefill, whose recurrent
state comes out of the prefill. The xLSTM cases (its smoke variant:
mLSTM + sLSTM, no attention layer) copy its ``{"C", "n", "m"}`` and
``{"c", "n", "h", "m"}`` caches (-inf stabilizers included) and run
``generate_continuous`` against JAX over the chunked forest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.core import verify as JV
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.drafter import SuffixDrafter as JSuffixDrafter
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.core.spec_engine import SpecEngine as JSpecEngine
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.core import verify as TV
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.scheduler import (
    FINISHED,
    PreemptionPolicy,
    Request,
)
from repro_torch.core.spec_engine import EngineConfig, RolloutStats, SpecEngine
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from test_torch_engine import (
    CFG,
    FAMILIES,
    MAX_NEW,
    MIN_GAP,
    PIDS,
    _min_top2_gap,
    _prompts,
)

SLOTS = 2
ENG_KW = dict(max_new_tokens=24, max_draft=4, block_buckets=(0, 2, 4),
              eos_token=1)


def _weights(family):
    jcfg, seed, _ = FAMILIES[family]
    jparams = make_params(jcfg, seed=seed)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jparams, cfg, params


@pytest.fixture(scope="module")
def weights():
    return _weights("dense")


@pytest.fixture(scope="module")
def hybrid_weights():
    return _weights("hybrid")


@pytest.fixture(scope="module")
def xlstm_weights():
    return _weights("xlstm")


XLSTM_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _eng_kw(family):
    return dict(ENG_KW, block_buckets=FAMILIES[family][2])


def _port_engine(weights, fuse="auto", layout="auto", eng_kw=ENG_KW):
    _, cfg, params = weights
    return SpecEngine(
        params, cfg, EngineConfig(fuse_rounds=fuse, **eng_kw),
        drafter=SuffixDrafter(DrafterConfig(
            scope="problem", min_match=1, device_tail=16,
            forest_layout=layout)),
        device="cpu",
    )


# ---------------------------------------------------------------------------
# copy_cache_rows and sample_token_rows
# ---------------------------------------------------------------------------

def _jax_layer_caches(jcache, cfg):
    """Per-layer numpy entries: (k, v, cpos), {"h", "conv"}, or an xLSTM
    state tuple as the port's dict."""
    out = []
    for si, (unit, repeats) in enumerate(cfg.scan_stages):
        for r in range(repeats):
            for ui, kind in enumerate(unit):
                entry = jax.tree.map(
                    lambda a: np.array(a[r] if repeats > 1 else a),
                    jcache.stages[si][ui])
                if kind in XLSTM_KEYS:
                    entry = dict(zip(XLSTM_KEYS[kind], entry))
                out.append(entry)
    return out


def _port_cache(jcache, cfg):
    layers = [jax.tree.map(torch.from_numpy, entry)
              for entry in _jax_layer_caches(jcache, cfg)]
    return TM.Cache(layers, torch.from_numpy(np.array(jcache.lengths)))


def _jax_prefill(jparams, prompts, jcfg=CFG, Tp=16, max_len=64):
    toks = np.zeros((len(prompts), Tp), np.int32)
    mask = np.zeros((len(prompts), Tp), bool)
    for b, p in enumerate(prompts):
        toks[b, Tp - len(p):] = p
        mask[b, Tp - len(p):] = True
    _, cache = JM.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(mask),
                          max_len=max_len)
    return cache


@pytest.mark.parametrize("family,slots", [
    pytest.param("dense", [2, 0, 4, 4], id="slots0"),
    pytest.param("dense", [3, 1, 0, 2], id="slots1"),
    pytest.param("dense", [1, 4, 4, 4], id="slots2"),
    pytest.param("hybrid", [2, 0, 4, 4], id="hybrid-slots0"),
    pytest.param("hybrid", [1, 4, 4, 4], id="hybrid-slots2"),
    pytest.param("xlstm", [3, 0, 4, 4], id="xlstm-slots0"),
])
def test_copy_cache_rows_equals_jax(weights, hybrid_weights, xlstm_weights,
                                    family, slots):
    """Padded entries (``n_slots`` = 4) are dropped by both packages; a
    hybrid model's RG-LRU layers copy both their ``h`` and ``conv``, an
    xLSTM model's layers every entry of their state."""
    jparams = {"dense": weights, "hybrid": hybrid_weights,
               "xlstm": xlstm_weights}[family][0]
    jcfg = FAMILIES[family][0]
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(2, 60, size=n)]
               for n in (3, 9, 14, 6, 11, 5, 8, 12)]
    jdst = _jax_prefill(jparams, prompts[:4], jcfg)
    jsrc = _jax_prefill(jparams, prompts[4:], jcfg)
    tdst = _port_cache(jdst, jcfg)
    want = JM.copy_cache_rows(jcfg, jdst, jsrc, jnp.asarray(slots, jnp.int32))
    got = TM.copy_cache_rows(jcfg, tdst, _port_cache(jsrc, jcfg),
                             np.asarray(slots, np.int32))
    assert got is tdst  # in place
    wl, gl = _jax_layer_caches(want, jcfg), got.layers
    assert len(wl) == len(gl) == jcfg.num_layers
    assert any(isinstance(g, dict) for g in gl) == (family != "dense")
    for w, g in zip(jax.tree.leaves(wl), jax.tree.leaves(gl)):
        np.testing.assert_array_equal(w, g.numpy())
    np.testing.assert_array_equal(np.asarray(want.lengths),
                                  got.lengths.numpy())


def test_admit_and_evict_state_rows_equal_jax(weights):
    """The fused-state admission and eviction writes, with slot lists
    padded by ``n_slots`` as the reference pads them, against the JAX
    engine's jitted writes."""
    from repro.core import fused_round as JF
    from repro_torch.core import fused_round as TF
    from repro_torch.core import spec_engine as TS

    n, m = 6, 5
    rng = np.random.default_rng(8)
    init = (rng.integers(2, 60, n), rng.integers(-1, 60, (n, m)),
            rng.random(n) < 0.5, rng.integers(0, 9, n), rng.integers(9, 30, n))
    jstate = JF.make_state(*init)
    tstate = TF.make_state(*init, "cpu")
    slots = np.array([4, 1, n, n], np.int32)
    heads = np.array([7, 8, 9, 10], np.int32)
    tails = rng.integers(-1, 60, (4, m)).astype(np.int32)
    max_new = np.array([11, 12, 13, 14], np.int32)
    emitted = np.array([1, 3, 1, 1], np.int32)
    jeng = JSpecEngine(weights[0], CFG, JEngineConfig(**ENG_KW))
    jstate = jeng._get_admit_state()(jstate, slots, heads, tails, max_new,
                                     emitted)
    TS.admit_state_rows(tstate, slots, heads, tails, max_new, emitted)
    evict = np.array([1, 0, n, n], np.int32)
    jstate = jeng._get_evict_state()(jstate, evict)
    TS.evict_state_rows(tstate, evict)
    for name, j, t in zip(JF.RoundState._fields, jstate,
                          (tstate.head, tstate.tails, tstate.active,
                           tstate.emitted, tstate.max_new)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_rows_matches_jax(temperature):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(5, 40)).astype(np.float32) * 2.0
    keys = jax.random.split(jax.random.key(11), 5)
    want = np.asarray(JV.sample_token_rows(
        jnp.asarray(logits), temperature=temperature,
        keys=keys if temperature > 0 else None))
    g = np.stack([np.array(jax.random.gumbel(k, (40,))) for k in keys])
    got = TV.sample_token_rows(torch.from_numpy(logits),
                               temperature=temperature,
                               gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# generate_continuous against JAX and against lock-step generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse,layout,family", [
    pytest.param("auto", "flat", "dense", id="auto-flat"),
    pytest.param("auto", "chunked", "dense", id="auto-chunked"),
    pytest.param("off", "flat", "dense", id="off-flat"),
    pytest.param("off", "chunked", "dense", id="off-chunked"),
    pytest.param("auto", "chunked", "hybrid", id="auto-chunked-hybrid"),
    # xLSTM continuous over the chunked forest (its flat forest runs in
    # the lock-step cases of tests/test_torch_engine.py)
    pytest.param("auto", "chunked", "xlstm", id="auto-chunked-xlstm"),
])
def test_generate_continuous_token_identical_to_jax(weights, hybrid_weights,
                                                    xlstm_weights, fuse,
                                                    layout, family):
    w = {"dense": weights, "hybrid": hybrid_weights,
         "xlstm": xlstm_weights}[family]
    jparams = w[0]
    jcfg = FAMILIES[family][0]
    eng_kw = _eng_kw(family)
    jeng = JSpecEngine(
        jparams, jcfg, JEngineConfig(fuse_rounds=fuse, **eng_kw),
        drafter=JSuffixDrafter(JDrafterConfig(
            scope="problem", min_match=1, device_tail=16,
            forest_layout=layout)),
    )
    teng = _port_engine(w, fuse, layout, eng_kw)
    lock = _port_engine(w, fuse, layout, eng_kw)
    prompts = _prompts(jcfg)
    total_accepted = 0
    for it in range(2):  # the second epoch drafts from the first's trees
        for e in (jeng, teng, lock):
            e.begin_iteration(it)
        jouts, jst = jeng.generate_continuous(
            prompts, PIDS, slots=SLOTS, max_new_tokens=MAX_NEW,
            key=jax.random.key(0))
        touts, tst = teng.generate_continuous(
            prompts, PIDS, slots=SLOTS, max_new_tokens=MAX_NEW)
        louts, _ = lock.generate(prompts, PIDS, max_new_tokens=MAX_NEW)
        assert _min_top2_gap(jparams, prompts, jouts, jcfg) > MIN_GAP
        assert touts == jouts
        assert louts == touts
        assert (tst.n_rounds, tst.n_fwd, tst.n_drafted, tst.n_accepted) == (
            jst.n_rounds, jst.n_fwd, jst.n_drafted, jst.n_accepted)
        np.testing.assert_array_equal(tst.per_row_rounds, jst.per_row_rounds)
        assert tst.n_toks_emitted == jst.n_toks_emitted
        total_accepted += tst.n_accepted
    assert total_accepted > 0, "the case must exercise accepted drafts"
    assert teng.drafter.stats["batched_proposes"] > 0


def _requests(limits, jcfg=CFG):
    prompts = _prompts(jcfg)
    return [Request(rid=i, problem_id=PIDS[i], prompt=list(prompts[i]),
                    max_new_tokens=limits[i]) for i in range(len(prompts))]


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_serve_recycles_on_eos_and_token_limit(weights, fuse):
    eng = _port_engine(weights, fuse, eng_kw=dict(ENG_KW, eos_token=40))
    limits = [4, 9, 2, 7]
    reqs = _requests(limits)
    stats = RolloutStats()
    done = list(eng.serve(reqs, slots=SLOTS, stats=stats))
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    for r in reqs:
        assert r.state == FINISHED and r.slot == -1 and r.session is None
        assert r.emitted == len(r.output) <= r.max_new_tokens
        assert 0 <= r.admit_round <= r.finish_round
    assert max(r.admit_round for r in reqs) > 0  # a recycled slot
    assert stats.n_toks_emitted == sum(len(r.output) for r in reqs)
    assert stats.n_rounds >= max(r.finish_round for r in reqs)
    # EOS (40) ends some rows before their limit, the rest stop at it
    lock = _port_engine(weights, fuse, eng_kw=dict(ENG_KW, eos_token=40))
    outs, _ = lock.generate([r.prompt for r in reqs], PIDS,
                            max_new_tokens=limits)
    assert [r.output for r in reqs] == outs
    assert any(len(o) < lim for o, lim in zip(outs, limits))
    assert any(len(o) == lim for o, lim in zip(outs, limits))


@pytest.mark.parametrize("fuse,family", [
    pytest.param("auto", "dense", id="auto"),
    pytest.param("off", "dense", id="off"),
    pytest.param("auto", "hybrid", id="auto-hybrid"),
])
def test_preempted_request_resumes_token_identically(weights, hybrid_weights,
                                                     fuse, family):
    w = weights if family == "dense" else hybrid_weights
    jcfg = FAMILIES[family][0]
    base = _requests(MAX_NEW, jcfg)
    list(_port_engine(w, fuse).serve(base, slots=SLOTS))
    reqs = _requests(MAX_NEW, jcfg)
    list(_port_engine(w, fuse).serve(
        reqs, slots=SLOTS, preemption=PreemptionPolicy(max_resident_rounds=2)))
    assert sum(r.n_preempted for r in reqs) > 0
    assert [r.output for r in reqs] == [r.output for r in base]
    assert all(r.state == FINISHED for r in reqs)


def test_cancelled_request_keeps_its_partial_output(weights):
    eng = _port_engine(weights)
    reqs = _requests(MAX_NEW)
    seen = []
    for fin in eng.serve(reqs, slots=SLOTS):
        seen.append(fin.rid)
        if len(seen) == 1:  # cancel everything still live
            for r in reqs:
                if r.state in ("queued", "running"):
                    r.cancel_requested = True
    assert sorted(seen) == list(range(len(reqs)))
    cancelled = [r for r in reqs if r.state == "cancelled"]
    assert cancelled
    lock, _ = _port_engine(weights).generate(_prompts(), PIDS,
                                             max_new_tokens=MAX_NEW)
    for r in cancelled:  # a prefix of the uninterrupted output
        assert r.output == lock[r.rid][: len(r.output)]


def test_sampled_serve_is_reproducible_from_the_generator(weights):
    kw = dict(ENG_KW, temperature=0.8)
    outs = []
    for _ in range(2):
        eng = _port_engine(weights, eng_kw=kw)
        o, st = eng.generate_continuous(
            _prompts(), PIDS, slots=SLOTS, max_new_tokens=MAX_NEW,
            generator=torch.Generator().manual_seed(7))
        assert all(len(x) <= m for x, m in zip(o, MAX_NEW))
        outs.append(o)
    assert outs[0] == outs[1]


def test_unported_serve_options_raise(weights, tmp_path):
    """The serve options that used to raise are ported: a journal leaves
    the outputs as they were and records them, and ``resume`` from the
    journaled prefixes gives the same outputs again."""
    from repro_torch.fault import RolloutJournal

    want, _ = _port_engine(weights).generate_continuous(
        _prompts(), PIDS, slots=SLOTS, max_new_tokens=MAX_NEW)
    j = RolloutJournal(str(tmp_path / "s.wal"))
    reqs = _requests(MAX_NEW)
    list(_port_engine(weights).serve(reqs, slots=SLOTS, journal=j))
    j.close()
    assert [r.output for r in reqs] == want
    sess = RolloutJournal.recover(str(tmp_path / "s.wal"))
    assert [sess[str(r.rid)].tokens for r in reqs] == want
    salvage = {str(i): o[: len(o) // 2] for i, o in enumerate(want) if o}
    got, _ = _port_engine(weights).generate_continuous(
        _prompts(), PIDS, slots=SLOTS, max_new_tokens=MAX_NEW,
        journal_keys=[str(i) for i in range(len(PIDS))], resume=salvage)
    assert got == want


# ---------------------------------------------------------------------------
# the serve CLI: xLSTM serves, the encoder-decoder is refused
# ---------------------------------------------------------------------------

SERVE_CLI = {
    "xlstm-lockstep": (["--arch", "xlstm-125m", "--rounds", "2"],
                       "tokens="),
    "xlstm-continuous": (["--arch", "xlstm-125m", "--rounds", "2",
                          "--continuous", "--slots", "4", "--requests", "8"],
                         "reqs / 4 slots"),
    "encdec-refused": (["--arch", "seamless-m4t-medium"],
                       "enc-dec serving smoke isn't wired through "
                       "SpecEngine"),
}


@pytest.mark.parametrize("case", sorted(SERVE_CLI))
def test_serve_cli_xlstm_and_encdec_refusal(case):
    """``launch.serve --smoke --device cpu``: xLSTM-125M's smoke variant
    serves lock-step and continuous, one line a round; the
    encoder-decoder exits non-zero with the reference's reason (the
    reference's ``SpecEngine`` does not serve one either)."""
    import os
    import subprocess
    import sys

    args, want = SERVE_CLI[case]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--smoke",
         "--device", "cpu"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    if case == "encdec-refused":
        assert out.returncode != 0 and want in out.stderr
        return
    assert out.returncode == 0, out.stderr[-2000:]
    rounds = [ln for ln in out.stdout.splitlines()
              if ln.startswith("round ")]
    assert len(rounds) == 2 and all(want in ln and "device=cpu" in ln
                                    for ln in rounds), out.stdout
