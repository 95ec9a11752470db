"""The port's workload step functions against the reference's
(``repro.launch.workloads``), at small widths on the same weights
(``convert``) and the same numpy inputs, float32:

* decode (two steps) and verify on the workloads' cache layout (slots
  rounded up to ``SLOT_MULTIPLE``, seeded K/V and recurrent states, rows
  at different lengths): next tokens equal, lengths equal (1 +
  accepted), every cache entry within the model tests' tolerances, for Qwen2-1.5B, the
  RecurrentGemma hybrid (verify gathers the staged states at the
  acceptance count) and SeamlessM4T with and without the cross cache;
  the verify blocks carry greedy drafts so that rows accept 8, 2 and 0;
* prefill (Qwen2-1.5B, left pads): last logits and the cache;
* the serve engine at ``slot_multiple`` 256 gives its outputs at 1.

The train step's parity is in ``tests/test_torch_workloads_train.py``.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.launch import workloads as JW
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.launch import workloads as W
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_model.py's
SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=96, vocab_pad_multiple=32)
ARCHS = {"qwen2": ("qwen2-1.5b", SMALL),
         "hybrid": ("recurrentgemma-9b",
                    dict(SMALL, num_kv_heads=1, rnn_width=64)),
         "encdec": ("seamless-m4t-medium", SMALL)}
S_ENC = 16
B = 3


def _cfgs(family):
    arch, over = ARCHS[family]
    jcfg = jsmoke(jget(arch)).replace(**over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _weights(family, seed=0):
    jcfg, _ = _cfgs(family)
    return jax.tree.map(np.asarray, make_params(jcfg, seed=seed))


def _models(family, trainable=False):
    jcfg, cfg = _cfgs(family)
    tree = _weights(family)
    params = params_from_numpy(tree, cfg, "cpu")
    if trainable:
        M.set_trainable(params)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params


def _both(d):
    """numpy dict → (JAX dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in d.items()})


def _enc_inputs(rng, cfg, key="enc_out"):
    mask = np.ones((B, S_ENC), bool)
    mask[1, 11:] = False
    mask[2, 5:] = False
    return {key: rng.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32),
            "enc_mask": mask}


# ---------------------------------------------------------------------------
# decode / verify on the workloads' cache layout
# ---------------------------------------------------------------------------

XLSTM_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _filled_cache(cfg, shape, rng):
    """The workloads' cache (``cache_specs``' layout, on the CPU) filled
    with seeded K/V at positions below each row's length and seeded
    recurrent states; per-layer numpy entries and the lengths."""
    lengths = np.array([20, 9, 14], np.int32)[:B]
    tmpl = M.init_cache(cfg, B, shape.seq_len + W.VERIFY_K + 2,
                        headroom=W.VERIFY_K + 8, device="cpu",
                        slot_multiple=W.SLOT_MULTIPLE)
    layers = []
    for entry in tmpl.layers:
        if isinstance(entry, dict):
            layers.append({k: rng.normal(size=v.shape).astype(
                np.float32) for k, v in entry.items()})
            continue
        k, v, cpos = (t.numpy().copy() for t in entry)
        S = k.shape[1] - 1
        assert (S + 1) % W.SLOT_MULTIPLE == 0
        for b, n in enumerate(lengths):
            p = np.arange(n)
            k[b, p % S] = rng.normal(size=(n,) + k.shape[2:])
            v[b, p % S] = rng.normal(size=(n,) + v.shape[2:])
            cpos[b, p % S] = p
        layers.append((k, v, cpos))
    return layers, lengths


def _port_cache(layers, lengths):
    def t(a):
        return torch.from_numpy(a.copy())
    return M.Cache([{k: t(a) for k, a in e.items()} if isinstance(e, dict)
                    else tuple(t(a) for a in e) for e in layers], t(lengths))


def _ref_cache(jcfg, layers, lengths):
    """The same entries in the reference's scan-staged layout."""
    stages, li = [], 0
    for unit, repeats in jcfg.scan_stages:
        reps = []
        for _ in range(repeats):
            unit_e = []
            for kind in unit:
                e = layers[li]
                li += 1
                if kind in XLSTM_KEYS:
                    e = tuple(e[k] for k in XLSTM_KEYS[kind])
                unit_e.append(e)
            reps.append(tuple(unit_e))
        if repeats > 1:
            reps = [jax.tree.map(lambda *a: np.stack(a), *reps)]
        stages.append(jax.tree.map(jnp.asarray, reps[0]))
    return JM.Cache(tuple(stages), jnp.asarray(lengths))


def _compare(jcfg, jcache, cache):
    want, li = [], 0
    for si, (unit, repeats) in enumerate(jcfg.scan_stages):
        for r in range(repeats):
            for ui, kind in enumerate(unit):
                e = jax.tree.map(lambda a: np.asarray(a[r] if repeats > 1
                                                      else a),
                                 jcache.stages[si][ui])
                if kind in XLSTM_KEYS:
                    e = dict(zip(XLSTM_KEYS[kind], e))
                want.append(e)
    assert len(want) == len(cache.layers)
    for we, ge in zip(want, cache.layers):
        if isinstance(we, dict):
            for k in we:
                np.testing.assert_allclose(ge[k].numpy(), we[k], **TOL)
            continue
        (jk, jv, jp), (k, v, p) = we, ge
        np.testing.assert_array_equal(p.numpy(), jp)
        S = jk.shape[1] - 1  # the trash slot's contents are unspecified
        np.testing.assert_allclose(k.numpy()[:, :S], jk[:, :S], **TOL)
        np.testing.assert_allclose(v.numpy()[:, :S], jv[:, :S], **TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(jcache.lengths))


CASES = [("qwen2", False), ("hybrid", False), ("encdec", False),
         ("encdec", True)]


@pytest.mark.parametrize("family,cross", CASES,
                         ids=["qwen2", "hybrid", "encdec", "encdec-cross"])
def test_decode_and_verify_steps_match_the_reference(family, cross):
    jcfg, cfg, jparams, params = _models(family)
    rng = np.random.default_rng(5)
    # the 32k shapes at a context of 40 (a ring of 256 slots)
    shape = W.InputShape("decode_32k", 40, B, "decode")
    vshape = W.InputShape("verify_8", 40, B, "verify")
    layers, lengths = _filled_cache(cfg, shape, rng)
    extra = _enc_inputs(rng, cfg) if cfg.is_encoder_decoder else {}
    head = rng.integers(2, cfg.vocab_size, size=(B, 1)).astype(np.int32)

    def batches(block, budgets=None):
        d = dict(extra, block=block)
        if budgets is not None:
            d["budgets"] = budgets
        jb, tb = _both(d)
        if cross:
            jb["cross_cache"] = JM.build_cross_cache(jparams, jcfg,
                                                     jb["enc_out"])
            tb["cross_cache"] = M.build_cross_cache(params, cfg, tb["enc_out"])
        return jb, tb

    jdec = JW.make_decode_fn(jcfg, JW.SHAPES["decode_32k"], cross)
    dec = W.make_decode_fn(cfg, shape, cross)
    # decode: two steps on both sides, then the port alone on to the
    # greedy chain of eight that the verify block drafts
    jcache, cache = _ref_cache(jcfg, layers, lengths), _port_cache(layers,
                                                                   lengths)
    tok, chain = head, []
    for step in range(W.VERIFY_K):
        jb, tb = batches(tok)
        nxt, cache = dec(params, cache, tb)
        if step < 2:
            jnext, jcache = jdec(jparams, jcache, jb)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
            _compare(jcfg, jcache, cache)
        tok = nxt.numpy().astype(np.int32)[:, None]
        chain.append(tok[:, 0])
    # verify from the filled cache: row 0 drafts the chain (accepts 8),
    # row 1 the chain's first two then others (2), row 2 others (0)
    drafts = np.stack(chain, 1)
    drafts[1, 2:] = (drafts[1, 2:] + 1) % cfg.vocab_size
    drafts[2] = (drafts[2] + 1) % cfg.vocab_size
    block = np.concatenate([head, drafts], 1).astype(np.int32)
    budgets = np.array([8, 6, 8], np.int32)
    jver = JW.make_decode_fn(jcfg, JW.SHAPES["verify_8"], cross)
    ver = W.make_decode_fn(cfg, vshape, cross)
    jcache, cache = _ref_cache(jcfg, layers, lengths), _port_cache(layers,
                                                                   lengths)
    jb, tb = batches(block, budgets)
    jnext, jcache = jver(jparams, jcache, jb)
    nxt, cache = ver(params, cache, tb)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    np.testing.assert_array_equal(cache.lengths.numpy() - lengths,
                                  [9, 3, 1])
    _compare(jcfg, jcache, cache)


def test_prefill_step_matches_the_reference():
    jcfg, cfg, jparams, params = _models("qwen2")
    rng = np.random.default_rng(9)
    S = 20
    tokens = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pad = np.ones((B, S), bool)
    pad[1, :7] = False
    pad[2, :13] = False
    shape = W.InputShape("prefill_32k", S, B, "prefill")
    jb, tb = _both({"tokens": tokens, "pad_mask": pad})
    jlast, jcache = JW.make_prefill_fn(jcfg, shape)(jparams, jb)
    last, cache = W.make_prefill_fn(cfg, shape)(params, tb)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    _compare(jcfg, jcache, cache)


# ---------------------------------------------------------------------------
# the serve engine on a ring rounded up to 256 slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["qwen2", "hybrid"])
def test_engine_outputs_do_not_depend_on_slot_multiple(family, monkeypatch):
    _, cfg, _, params = _models(family)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in (7, 4, 11, 6)]
    pids = ["a", "b", "a", "c"]
    init_cache = M.init_cache
    slots = []

    def run(multiple):
        def spy(*a, **kw):
            kw.setdefault("slot_multiple", multiple)
            c = init_cache(*a, **kw)
            slots.extend(e[0].shape[1] for e in c.layers
                         if not isinstance(e, dict))
            return c

        monkeypatch.setattr(M, "init_cache", spy)
        eng = SpecEngine(copy.deepcopy(params), cfg, EngineConfig(
            max_new_tokens=16, max_draft=4, block_buckets=(0, 4),
            eos_token=1), drafter=SuffixDrafter(DrafterConfig(
                scope="problem", min_match=1, device_tail=16)),
            device="cpu")
        outs = []
        for it in range(2):
            eng.begin_iteration(it)
            outs.append(eng.generate(prompts, pids, max_new_tokens=16)[0])
        outs.append(eng.generate_continuous(prompts, pids, slots=2,
                                            max_new_tokens=12)[0])
        return outs

    base = run(1)
    assert slots and all(s % 256 for s in slots)
    slots.clear()
    assert run(W.SLOT_MULTIPLE) == base
    assert slots and all(s % 256 == 0 for s in slots)
