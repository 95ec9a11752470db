"""The port's lock-step ``SpecEngine.generate`` against the JAX engine,
for a tiny dense decoder and for RecurrentGemma's smoke variant (hybrid:
RG-LRU + local attention, so verify rounds collect staged recurrent
states and gather them at the acceptance count).

Same weights (JAX ``init_params`` through numpy), same prompts and
problem ids, T = 0. Mixtral's smoke variant (MoE, whose capacity makes a
token depend on its forward's other tokens, so identity also holds the
port to the reference's batches: pads and dead rows routed too) and
Command R+'s (parallel blocks) run the fused path, xLSTM's (mLSTM and
sLSTM, staged states, no attention layer) the fused and the unfused
paths. Two ``generate`` calls over the same problems, so the
second drafts from the first one's trees. Checked for the fused path
(``fuse_rounds="auto"``, scope ``problem``: device drafting through the
suffix-match plain version) and the unfused path (``fuse_rounds="off"``,
scope ``problem+request``: host sessions). Outputs must be
token-identical and ``n_rounds``/``n_drafted``/``n_accepted`` equal.

Greedy parity across frameworks needs no near-tie on the emitted path:
the logits agree to ~2e-4 (tests/test_torch_model.py), so the test
asserts that JAX's top-2 logit gap at every emitted position stays above
1e-3. The weight and prompt seeds below were chosen so that it does.

``RolloutStats.modeled_latency`` (the paper's latency model J) equals
the reference's on the same counts, and DAS lowers it on the pattern task
once a first epoch has built history (``tests/test_system.py``'s check,
on the port).
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
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.drafter import SuffixDrafter as JSuffixDrafter
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.core.spec_engine import SpecEngine as JSpecEngine
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.models.convert import params_from_numpy
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

CFG = JModelConfig(
    name="engine-dense", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
    vocab_pad_multiple=8, dtype="float32",
)
WEIGHT_SEED = 0
PROMPT_SEED = 1
# RecurrentGemma-9B's smoke variant (3 layers: rglru, rglru, local_attn;
# vocab 1024); weight seed 4 keeps the top-2 gap above MIN_GAP. One K
# bucket: each bucket is one more JAX compilation of the hybrid round.
HYBRID = jax_smoke_variant(jax_get_config("recurrentgemma-9b"))
# Mixtral's smoke variant (MoE: 4 experts, top 2, capacity 1.25, window
# 64) and Command R+'s (parallel blocks, LayerNorm, tied embeddings), one
# K bucket each. A MoE token's output depends on the other tokens of its
# forward (the capacity), so identity also needs the port to route the
# same batches of tokens as the reference: pads and dead rows included.
MOE = jax_smoke_variant(jax_get_config("mixtral-8x7b"))
PARALLEL = jax_smoke_variant(jax_get_config("command-r-plus-104b"))
# xLSTM's smoke variant (mlstm, slstm; no attention layer, so no ring and
# no spec-verify; staged states for both blocks); weight seed 6 keeps the
# top-2 gap above MIN_GAP
XLSTM = jax_smoke_variant(jax_get_config("xlstm-125m"))
FAMILIES = {"dense": (CFG, WEIGHT_SEED, (0, 2, 4)),
            "hybrid": (HYBRID, 4, (4,)),
            "moe": (MOE, 0, (4,)),
            "parallel": (PARALLEL, 5, (4,)),
            "xlstm": (XLSTM, 6, (4,))}
MAX_NEW = [24, 12, 30, 18]
PIDS = ["a", "b", "a", "c"]
MIN_GAP = 1e-3  # 5x the cross-framework logits tolerance


def _prompts(jcfg=CFG):
    rng = np.random.default_rng(PROMPT_SEED)
    base = {pid: [int(t) for t in rng.integers(2, jcfg.vocab_size, size=n)]
            for pid, n in (("a", 7), ("b", 4), ("c", 11))}
    return [base[p] for p in PIDS]


def _engines(fuse, scope, family="dense"):
    jcfg, seed, buckets = FAMILIES[family]
    eng_kw = dict(max_new_tokens=24, max_draft=4, block_buckets=buckets,
                  eos_token=1, fuse_rounds=fuse)
    dr_kw = dict(scope=scope, min_match=1, device_tail=16)
    jparams = make_params(jcfg, seed=seed)
    jeng = JSpecEngine(jparams, jcfg, JEngineConfig(**eng_kw),
                       drafter=JSuffixDrafter(JDrafterConfig(**dr_kw)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    teng = SpecEngine(params, cfg, EngineConfig(**eng_kw),
                      drafter=SuffixDrafter(DrafterConfig(**dr_kw)),
                      device="cpu")
    return jparams, jeng, teng


_forward = jax.jit(JM.forward, static_argnums=1)


def _min_top2_gap(jparams, prompts, outs, jcfg=CFG):
    """Smallest JAX top-2 logit gap over the positions that emitted. One
    jitted forward over every row right-padded to one length: the model
    is causal, so a position's logits see only the tokens up to it."""
    seqs = [list(p) + list(o) for p, o in zip(prompts, outs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for b, seq in enumerate(seqs):
        toks[b, :len(seq)] = seq
    logits = np.asarray(_forward(jparams, jcfg, jnp.asarray(toks))[0])
    gap = np.inf
    for b, (p, o) in enumerate(zip(prompts, outs)):
        if not o:
            continue
        lg = logits[b, len(p) - 1: len(p) - 1 + len(o), : jcfg.vocab_size]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gap = min(gap, float((top2[:, 1] - top2[:, 0]).min()))
    return gap


@pytest.mark.parametrize("fuse,scope,family", [
    ("auto", "problem", "dense"), ("off", "problem+request", "dense"),
    ("auto", "problem", "hybrid"), ("off", "problem+request", "hybrid"),
    # the main (fused) path only for the families whose layers, not
    # rounds, are new: each case is one more JAX compilation
    ("auto", "problem", "moe"), ("auto", "problem", "parallel"),
    # xLSTM: fused and unfused rounds (its recurrent state, not its layers,
    # is what the rounds carry)
    ("auto", "problem", "xlstm"), ("off", "problem+request", "xlstm"),
])
def test_generate_token_identical_to_jax(fuse, scope, family):
    jparams, jeng, teng = _engines(fuse, scope, family)
    jcfg = FAMILIES[family][0]
    prompts = _prompts(jcfg)
    total_accepted = 0
    for it in range(2):  # the second pass drafts from the first's trees
        jeng.begin_iteration(it)
        teng.begin_iteration(it)
        jouts, jst = jeng.generate(prompts, PIDS, max_new_tokens=MAX_NEW,
                                   key=jax.random.key(0))
        touts, tst = teng.generate(prompts, PIDS, max_new_tokens=MAX_NEW)
        assert _min_top2_gap(jparams, prompts, jouts, jcfg) > MIN_GAP
        assert touts == jouts
        assert (tst.n_rounds, tst.n_drafted, tst.n_accepted) == (
            jst.n_rounds, jst.n_drafted, jst.n_accepted)
        assert tst.n_toks_emitted == jst.n_toks_emitted
        total_accepted += tst.n_accepted
    assert total_accepted > 0, "the case must exercise accepted drafts"
    if fuse == "auto":
        assert teng.drafter.stats["batched_proposes"] > 0


@pytest.mark.parametrize("n_fwd,n_toks", [(0, 0), (14, 568), (65, 1040),
                                          (3, 7)])
def test_modeled_latency_equals_jax(n_fwd, n_toks):
    from repro.core.budget import LatencyModel as JLatencyModel
    from repro.core.spec_engine import RolloutStats as JRolloutStats
    from repro_torch.core.budget import LatencyModel
    from repro_torch.core.spec_engine import RolloutStats

    for kw in ({}, dict(c_base=10.0, c_tok=0.01),
               dict(c_base=2.5, c_tok=0.125, overhead=3.0)):
        want = JRolloutStats(n_fwd=n_fwd, n_toks_proposed=n_toks)\
            .modeled_latency(JLatencyModel(**kw))
        got = RolloutStats(n_fwd=n_fwd, n_toks_proposed=n_toks)\
            .modeled_latency(LatencyModel(**kw))
        assert got == want, kw


def test_modeled_latency_improves_with_das(one_torch_thread):
    """``tests/test_system.py``'s check on the port: epoch 2's DAS rollout
    of the pattern task costs less under J than the plain rollout."""
    from repro.data.tokenizer import TOKENIZER
    from repro_torch.core.budget import LatencyModel
    from repro_torch.data.tasks import PatternTask
    from repro_torch.rl.rollout import RolloutWorker

    jcfg = JModelConfig(
        name="sys", family="dense", num_layers=2, d_model=96, num_heads=4,
        num_kv_heads=2, d_ff=192, vocab_size=TOKENIZER.vocab_size,
        vocab_pad_multiple=8, dtype="float32",
    )
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(
        jax.tree.map(np.asarray, make_params(jcfg)), cfg, "cpu")
    task = PatternTask(n_problems=6, mean_len=14.0, sigma=0.7, max_len=40,
                       seed=3)
    probs = task.problems()
    lat = LatencyModel(c_base=10.0, c_tok=0.01)
    base = SpecEngine(params, cfg, EngineConfig(
        spec_enabled=False, max_new_tokens=30, eos_token=1), device="cpu")
    das = SpecEngine(
        params, cfg,
        EngineConfig(spec_enabled=True, max_new_tokens=30, eos_token=1,
                     use_budget_solver=False),
        drafter=SuffixDrafter(DrafterConfig(scope="problem+request",
                                            min_match=2)),
        latency=lat, device="cpu")
    w0 = RolloutWorker(base, task, group_size=1)
    w1 = RolloutWorker(das, task, group_size=1)
    b0 = w0.rollout(probs)
    w1.rollout(probs)  # epoch 0: builds history
    das.begin_iteration(1)
    b1 = w1.rollout(probs)
    assert b1.responses == b0.responses
    t0 = b0.stats.modeled_latency(lat)
    t1 = b1.stats.modeled_latency(lat)
    assert t1 < t0, (t0, t1)
