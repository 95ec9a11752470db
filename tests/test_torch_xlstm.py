"""The port's xLSTM blocks and the recurrent blocks' ``commit_upto``
branch against the JAX package (float32, the tolerances of
tests/test_torch_model.py).

* ``apply_mlstm`` / ``apply_slstm`` on the same weights and inputs as the
  reference's: outputs, the dynamic state, the committed carry of
  ``commit_upto`` (nothing, a prefix, everything, and past both ends)
  and the staged ``collect`` states (B, T+1, ...), from a fresh state (m
  at -inf) and from a carried one, with left pads and a frozen row in
  ``update_mask``; -inf stays exactly where the reference has it.
* The ports of tests/test_models.py's ``xlstm`` family: cached decode,
  one token a step with ``commit_upto``, against the full forward and
  against the reference's logits; and a verify block with partial
  acceptance (``commit_upto``), for the hybrid and for xLSTM, leaving
  the cache the reference leaves and the one a token-by-token decode of
  the accepted prefix leaves.
* The two commit schemes agree: staged states gathered at n_commit
  (``commit_staged_cache``) equal a ``commit_upto`` forward's committed
  carry, and the -inf stabilizer passes ``copy_cache_rows`` and a
  left-padded prefill without NaN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

TOL = dict(atol=2e-4, rtol=2e-4)
# the reference's functions jitted, as its engine runs them
_jforward = jax.jit(JM.forward, static_argnums=1)
_jprefill = jax.jit(JM.prefill, static_argnums=(1, 4))
TOL_BLOCK = dict(atol=1e-5, rtol=1e-5)
KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _port(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def xcfg():
    # xLSTM's smoke pattern at a small width: 4 heads of 16
    jcfg = jax_smoke_variant(jax_get_config("xlstm-125m")).replace(
        d_model=64, rnn_width=64)
    return jcfg, _port(jcfg)


def _block_params(kind, jcfg):
    jp = JL.split_tree(getattr(JL, "init_" + kind)(jax.random.key(7),
                                                   jcfg))[0]
    return jp, {k: tensor_from_numpy(np.asarray(v), "cpu")
                for k, v in jp.items()}


def _state_pair(kind, js):
    return dict(zip(KEYS[kind], (np.asarray(a) for a in js)))


def _compare_state(kind, got, want, tol):
    assert sorted(got) == sorted(KEYS[kind])
    for key in KEYS[kind]:
        g, w = got[key].numpy(), want[key]
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        assert not np.isnan(g).any(), key
        np.testing.assert_allclose(g, w, err_msg=key, **tol)


# name -> (update mask?, commit_upto per row or None, collect, carried state)
BLOCK_CASES = {
    "fresh": (False, None, False, False),
    "fresh_masked_collect": (True, None, True, False),
    "carried_masked": (True, None, False, True),
    "carried_collect": (True, None, True, True),
    "commit_inside": (True, (0, 3, 6), False, True),
    "commit_outside": (True, (-1, 9, 2), False, True),
    "commit_fresh": (False, (6, 0, 4), False, False),
}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_xlstm_block_matches_jax(xcfg, kind, case):
    jcfg, cfg = xcfg
    masked, upto, collect, carried = BLOCK_CASES[case]
    jp, tp = _block_params(kind, jcfg)
    japply, tapply = getattr(JL, "apply_" + kind), getattr(TL, "apply_" + kind)
    B, T = 3, 6
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if carried:  # the state after a 4-token prefix: m finite
        x0 = rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32)
        _, jstate = japply(jp, jnp.asarray(x0), jcfg)
        _, tstate = tapply(tp, torch.from_numpy(x0), cfg)
        _compare_state(kind, tstate, _state_pair(kind, jstate), TOL_BLOCK)
    valid = np.ones((B, T), bool)
    if masked:
        valid[0, :2] = False  # left pads
        valid[2] = False  # a frozen row
    jkw = dict(update_mask=jnp.asarray(valid) if masked else None,
               commit_upto=None if upto is None else jnp.asarray(upto),
               collect=collect)
    tkw = dict(update_mask=torch.from_numpy(valid) if masked else None,
               commit_upto=None if upto is None else torch.tensor(upto),
               collect=collect)
    jy, js = japply(jp, jnp.asarray(x), jcfg, jstate, **jkw)
    ty, ts = tapply(tp, torch.from_numpy(x), cfg, tstate, **tkw)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_BLOCK)
    want = _state_pair(kind, js)
    _compare_state(kind, ts, want, TOL_BLOCK)
    if collect:  # index 0 is the state before the block
        lead = ts[KEYS[kind][0]].shape[:2]
        assert tuple(lead) == (B, T + 1)
        before = tstate or {k: ts[k][:, 0] for k in KEYS[kind]}
        for key in KEYS[kind]:
            assert torch.equal(ts[key][:, 0], before[key])
            if masked:  # the frozen row never moves
                assert torch.equal(ts[key][2, -1], before[key][2])


# tests/test_models.py's ``xlstm`` family (BASE + FAMILIES["xlstm"])
XLSTM_FAMILY = JModelConfig(
    name="xlstm", family="ssm", block_pattern=("mlstm", "slstm"), d_ff=0,
    num_layers=4, rnn_width=64, d_model=64, num_heads=4, num_kv_heads=2,
    vocab_size=97, vocab_pad_multiple=8, dtype="float32")
HYBRID_FAMILY = JModelConfig(
    name="hyb", family="hybrid",
    block_pattern=("rglru", "rglru", "local_attn"), num_layers=5, local_window=6, rnn_width=64, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=97, vocab_pad_multiple=8,
    dtype="float32")


def _models(jcfg, seed=0):
    jp = make_params(jcfg, seed=seed)
    cfg = _port(jcfg)
    return jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")


def test_cached_decode_matches_full_forward_xlstm():
    """tests/test_models.py:44 for the xlstm family: prefill the ragged
    prompts, then decode the rest one token a step (frozen rows invalid,
    ``commit_upto`` 1 on live rows); every step's logits equal the full
    forward's (the reference's bound, 2e-2) and the reference's own
    cached logits (TOL)."""
    jp, cfg, tp = _models(XLSTM_FAMILY)
    B, T = 3, 12
    toks = np.array(jax.random.randint(jax.random.key(1), (B, T), 0,
                                       cfg.vocab_size), np.int32)
    full = TM.forward(tp, cfg, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_allclose(
        full, np.asarray(_jforward(jp, XLSTM_FAMILY, jnp.asarray(toks))[0]),
        **TOL)
    plens = [5, 7, 12]
    pad = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), bool)
    for b, pl in enumerate(plens):
        pad[b, T - pl:] = toks[b, :pl]
        mask[b, T - pl:] = True
    last, cache = TM.prefill(tp, cfg, torch.from_numpy(pad),
                             torch.from_numpy(mask), max_len=32)
    jlast, jcache = _jprefill(jp, XLSTM_FAMILY, jnp.asarray(pad),
                              jnp.asarray(mask), 32)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    for b, pl in enumerate(plens):
        np.testing.assert_allclose(last[b].numpy(), full[b, pl - 1],
                                   atol=2e-2, rtol=1e-2)
    lengths = np.array(plens)
    for _ in range(T - min(plens)):
        feed = np.zeros((B, 1), np.int32)
        val = np.zeros((B, 1), bool)
        for b in range(B):
            if lengths[b] < T:
                feed[b, 0] = toks[b, lengths[b]]
                val[b, 0] = True
        upto = val[:, 0].astype(np.int32)
        logits, cache = TM.forward(tp, cfg, torch.from_numpy(feed),
                                   cache=cache, valid=torch.from_numpy(val),
                                   commit_upto=torch.from_numpy(upto))
        jlogits, jcache, _ = _jforward(
            jp, XLSTM_FAMILY, jnp.asarray(feed), cache=jcache,
            valid=jnp.asarray(val), commit_upto=jnp.asarray(upto))
        cache.lengths += torch.from_numpy(upto)
        jcache = jcache._replace(lengths=jcache.lengths + upto)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        for b in range(B):
            if val[b, 0]:
                np.testing.assert_allclose(
                    logits[b, 0].numpy(), full[b, lengths[b]],
                    atol=2e-2, rtol=1e-2, err_msg=f"b={b}")
        lengths = lengths + val[:, 0]
    assert (lengths == T).all()


def _jax_entries(jcache, jcfg):
    out = []
    for si, (unit, repeats) in enumerate(jcfg.scan_stages):
        for r in range(repeats):
            for ui, kind in enumerate(unit):
                e = jax.tree.map(lambda a: np.asarray(a[r] if repeats > 1
                                                      else a),
                                 jcache.stages[si][ui])
                out.append(dict(zip(KEYS[kind], e)) if kind in KEYS else e)
    return out


def _assert_cache_equal(tcache, entries, tol):
    for tl, jl in zip(tcache.layers, entries):
        if isinstance(jl, dict):
            for key, want in jl.items():
                np.testing.assert_array_equal(
                    np.isneginf(tl[key].numpy()), np.isneginf(want))
                np.testing.assert_allclose(tl[key].numpy(), want,
                                           err_msg=key, **tol)
        else:
            S = jl[0].shape[1] - 1  # the trash slot's contents vary
            np.testing.assert_array_equal(tl[2].numpy(), jl[2])
            for t, j in zip(tl[:2], jl[:2]):
                np.testing.assert_allclose(t.numpy()[:, :S], j[:, :S], **tol)


@pytest.mark.parametrize("family", ["hybrid", "xlstm"])
def test_verify_block_partial_acceptance_commit(family):
    """tests/test_models.py:95 on both sides: a 4-token verify block
    with ``commit_upto`` = [1, 3] leaves the cache the reference's
    leaves (its dual carry; the hybrid's RG-LRU carry gathered from the
    kernel's hs), and the next step's logits equal those after decoding
    the accepted tokens one by one (the reference's bound, 2e-2, and the
    reference's own logits within TOL)."""
    jcfg = HYBRID_FAMILY if family == "hybrid" else XLSTM_FAMILY
    jp, cfg, tp = _models(jcfg)
    B = 2
    prompt = np.asarray(jax.random.randint(jax.random.key(2), (B, 5), 0,
                                           cfg.vocab_size), np.int32)
    block = np.asarray(jax.random.randint(jax.random.key(3), (B, 4), 0,
                                          cfg.vocab_size), np.int32)
    nxt = np.asarray(jax.random.randint(jax.random.key(4), (B, 1), 0,
                                        cfg.vocab_size), np.int32)
    accepted = np.array([1, 3], np.int32)
    ones = np.ones((B, 4), bool)

    def tprefill():
        return TM.prefill(tp, cfg, torch.from_numpy(prompt),
                          torch.ones((B, 5), dtype=torch.bool), max_len=32)[1]

    _, jcache = _jprefill(jp, jcfg, jnp.asarray(prompt),
                          jnp.ones((B, 5), bool), 32)
    _, jblk, _ = _jforward(jp, jcfg, jnp.asarray(block), cache=jcache,
                            valid=jnp.asarray(ones),
                            commit_upto=jnp.asarray(accepted))
    jblk = jblk._replace(lengths=jblk.lengths + accepted)
    cache_blk = tprefill()
    _, cache_blk = TM.forward(tp, cfg, torch.from_numpy(block),
                              cache=cache_blk, valid=torch.from_numpy(ones),
                              commit_upto=torch.from_numpy(accepted))
    cache_blk.lengths += torch.from_numpy(accepted)
    _assert_cache_equal(cache_blk, _jax_entries(jblk, jcfg), TOL)
    cache_ref = tprefill()
    for t in range(4):
        live = t < accepted
        _, cache_ref = TM.forward(
            tp, cfg, torch.from_numpy(block[:, t:t + 1]), cache=cache_ref,
            valid=torch.from_numpy(live[:, None]),
            commit_upto=torch.from_numpy(live.astype(np.int32)))
        cache_ref.lengths += torch.from_numpy(live.astype(np.int32))
    one = torch.ones((B, 1), dtype=torch.bool)
    l1 = TM.forward(tp, cfg, torch.from_numpy(nxt), cache=cache_blk,
                    valid=one, commit_upto=torch.ones(B, dtype=torch.int32))[0]
    l2 = TM.forward(tp, cfg, torch.from_numpy(nxt), cache=cache_ref,
                    valid=one, commit_upto=torch.ones(B, dtype=torch.int32))[0]
    jl1 = _jforward(jp, jcfg, jnp.asarray(nxt), cache=jblk,
                     valid=jnp.ones((B, 1), bool),
                     commit_upto=jnp.ones((B,), jnp.int32))[0]
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), **TOL)


def test_staged_gather_equals_committed_carry():
    """The serving path's single pass (staged states gathered at n_commit)
    and the dual carry (``commit_upto`` = n_commit) commit the same
    states, bit for bit in every xLSTM layer; a frozen row (n_commit 0)
    keeps its state."""
    jcfg = jax_smoke_variant(jax_get_config("xlstm-125m"))
    cfg = _port(jcfg)
    params = TM.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 7)))
    mask = torch.ones((3, 7), dtype=torch.bool)
    mask[1, :3] = False
    block = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 5)))
    valid = torch.ones((3, 5), dtype=torch.bool)
    valid[2] = False
    n_commit = torch.tensor([2, 5, 0])
    caches = [TM.prefill(params, cfg, toks, mask, max_len=32)[1]
              for _ in range(2)]
    la, staged = TM.forward(params, cfg, block, cache=caches[0], valid=valid,
                            collect_states=True)
    TM.commit_staged_cache(cfg, caches[0], staged, n_commit)
    lb, _ = TM.forward(params, cfg, block, cache=caches[1], valid=valid,
                       commit_upto=n_commit)
    assert torch.equal(la, lb)
    for a, b in zip(caches[0].layers, caches[1].layers):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_neg_inf_stabilizer_survives_pads_and_row_copies():
    """m starts at -inf: a left-padded prefill leaves it at -inf on no
    row that saw a token, and nowhere NaN; ``copy_cache_rows`` carries
    -inf into a fresh pool untouched."""
    jcfg = jax_smoke_variant(jax_get_config("xlstm-125m"))
    cfg = _port(jcfg)
    params = TM.init_params(cfg, seed=4, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    mask = torch.ones((2, 6), dtype=torch.bool)
    mask[1, :5] = False  # one real token
    last, cache = TM.prefill(params, cfg, toks, mask, max_len=16)
    assert torch.isfinite(last).all()
    for c in cache.layers:
        assert torch.isfinite(c["m"]).all()
        assert not any(torch.isnan(v).any() for v in c.values())
    pool = TM.init_cache(cfg, 4, 16, device="cpu")
    TM.copy_cache_rows(cfg, pool, cache, np.array([3, 9]))  # 9: dropped
    for c, src in zip(pool.layers, cache.layers):
        assert torch.isneginf(c["m"][:3]).all()
        for key in c:
            assert torch.equal(c[key][3], src[key][0])
