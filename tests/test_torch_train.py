"""The port's RL loop end to end, on the CPU:

* ``Trainer`` parity with the JAX package at temperature 0: the same
  weights (JAX ``init_params`` through numpy), the smoke qwen2-1.5b and
  the smoke hybrid (RecurrentGemma-9B's pattern at the same width: its
  learner's gradient runs through the RG-LRU scan's backward) on the
  pattern task, 2 SFT warmup steps then 3 GRPO steps; every rollout
  equal token for token, ``reward_mean`` equal, the SFT loss within
  rtol 1e-4, ``loss`` and ``grad_norm`` within rtol 1e-3, atol 1e-5
  (float32; XLA and PyTorch sum in other orders, and Adam's first steps
  are about lr·sign(g), so the weights drift apart a little);
* warm resume (``tests/test_warm_start.py``'s check, on the port): a
  trainer resumed from the step-2 checkpoint has the drafter's windows
  and cursor back, and its rollouts, metrics and final weights equal the
  uninterrupted run's — at temperature 0 and, since the sidecar carries
  the generator's state, at temperature 0.7 as well (and for the hybrid
  at 0.7);
* ``RolloutWorker`` at T = 0: the JAX worker's batch, the port's
  lock-step one and its continuous one (2 slots) are equal;
* ``python -m repro_torch.launch.train --smoke --device cpu`` prints a
  JSON line a step, for qwen2-1.5b and recurrentgemma-9b; without ``--device cpu`` and no card it raises;
  ``--dry-run`` exits non-zero naming the missing module; the trainer
  branches that once raised (multi-worker, fault tolerance, journals,
  flight recorder) build and close.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.data.tasks import PatternTask as JPatternTask
from repro.data.tokenizer import TOKENIZER
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.rl.trainer import Trainer as JTrainer
from repro.rl.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig
from repro_torch.core.spec_engine import EngineConfig
from repro_torch.data.tasks import PatternTask
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rl.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JCFG = jax_smoke_variant(jax_get_config("qwen2-1.5b")).replace(
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
JCFG_HYBRID = jax_smoke_variant(jax_get_config("recurrentgemma-9b")).replace(
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
    rnn_width=64, vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8)
CFG_HYBRID = ModelConfig(**dataclasses.asdict(JCFG_HYBRID))


def _kw(path, steps, temperature=0.0, **over):
    kw = dict(
        steps=steps, prompts_per_step=2, group_size=2, max_new_tokens=12,
        temperature=temperature, seed=11, sft_warmup_steps=2,
        ckpt_path=str(path), ckpt_every=2,
    )
    kw.update(over)
    return kw


def _capture(tr, log):
    orig = tr.worker.rollout

    def wrapped(*a, **k):
        batch = orig(*a, **k)
        log.append([list(r) for r in batch.responses])
        return batch

    tr.worker.rollout = wrapped


def _port_trainer(path, steps, params=None, cfg=CFG, **kw):
    return Trainer(
        cfg, PatternTask(n_problems=4, mean_len=8.0, sigma=0.3, max_len=12,
                         seed=0),
        TrainerConfig(
            optim=AdamWConfig(lr=1e-3),
            engine=EngineConfig(max_draft=4, block_buckets=(0, 4)),
            drafter=DrafterConfig(scope="problem", window_size=4,
                                  min_match=1),
            **_kw(path, steps, **kw)),
        params=params, device="cpu")


def _trainer_matches_jax_at_t0(tmp_path, jcfg, cfg):
    jparams = make_params(jcfg, seed=3)
    jtr = JTrainer(
        jcfg, JPatternTask(n_problems=4, mean_len=8.0, sigma=0.3, max_len=12,
                           seed=0),
        JTrainerConfig(
            optim=JAdamWConfig(lr=1e-3),
            engine=JEngineConfig(max_draft=4, block_buckets=(0, 4)),
            drafter=JDrafterConfig(scope="problem", window_size=4,
                                   min_match=1),
            **_kw(tmp_path / "j", 3, ckpt_every=0)),
        params=jparams)
    tr = _port_trainer(tmp_path / "t", 3, ckpt_every=0, cfg=cfg,
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    jrolls, rolls = [], []
    _capture(jtr, jrolls)
    _capture(tr, rolls)
    jsft = jtr.sft_warmup()
    sft = tr.sft_warmup()
    np.testing.assert_allclose(sft, jsft, rtol=1e-4)
    jh, h = jtr.run(), tr.run()
    tr.close()
    jtr.close()
    assert len(h) == len(jh) == 3
    assert rolls == jrolls, "rollouts differ from the JAX trainer's"
    assert sum(len(r) for rs in rolls for r in rs) > 0
    for a, b in zip(h, jh):
        assert a["reward_mean"] == b["reward_mean"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)


def test_trainer_matches_jax_at_t0(tmp_path):
    _trainer_matches_jax_at_t0(tmp_path, JCFG, CFG)


def test_trainer_matches_jax_at_t0_hybrid(tmp_path):
    _trainer_matches_jax_at_t0(tmp_path, JCFG_HYBRID, CFG_HYBRID)


def _resume_is_token_identical(tmp_path, temperature, cfg):
    tr_a = _port_trainer(tmp_path / "a", 4, temperature=temperature, cfg=cfg)
    rolls_a = []
    _capture(tr_a, rolls_a)
    hist_a = tr_a.run()
    tr_a.close()
    assert len(hist_a) == 4

    tr_b = _port_trainer(tmp_path / "a", 4, temperature=temperature, cfg=cfg)
    tr_b.load_checkpoint(str(tmp_path / "a" / "step2.npz"))
    assert tr_b._step == 2 and len(tr_b.history) == 2
    # the resumed drafter is warm: persisted windows, rebuilt trees
    assert tr_b.engine.drafter.store.n_rollouts == \
        tr_a.engine.drafter.store.n_rollouts - 8  # 2 steps x 2x2 rollouts
    assert tr_b.engine.drafter.store.n_rollouts > 0
    rolls_b = []
    _capture(tr_b, rolls_b)
    hist_b = tr_b.run()
    tr_b.close()
    assert len(hist_b) == 4
    assert len(rolls_a) == 4 and len(rolls_b) == 2
    assert rolls_b == rolls_a[2:], "resumed rollouts diverged"
    for ra, rb in zip(hist_a[2:], hist_b[2:]):
        assert ra["loss"] == rb["loss"]
        assert ra["reward_mean"] == rb["reward_mean"]
    for (n, a), (_, b) in zip(tr_a.params.named_parameters(),
                              tr_b.params.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_resume_is_token_identical(tmp_path, temperature):
    _resume_is_token_identical(tmp_path, temperature, CFG)


def test_resume_is_token_identical_hybrid(tmp_path):
    _resume_is_token_identical(tmp_path, 0.7, CFG_HYBRID)


def test_rollout_worker_matches_jax_lockstep_and_continuous():
    """``RolloutWorker`` at T = 0 on the same weights: the JAX worker's
    batch (lock-step), the port's lock-step and continuous (2 slots for 6
    requests) batches are equal: responses, rewards, advantages and the
    packed train arrays."""
    from repro.core.drafter import SuffixDrafter as JSuffixDrafter
    from repro.core.spec_engine import SpecEngine as JSpecEngine
    from repro.rl.rollout import RolloutWorker as JRolloutWorker
    from repro_torch.core.drafter import SuffixDrafter
    from repro_torch.core.spec_engine import SpecEngine
    from repro_torch.rl.rollout import RolloutWorker

    jparams = make_params(JCFG, seed=6)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    jtask = JPatternTask(n_problems=3, mean_len=8.0, max_len=12, seed=2)
    task = PatternTask(n_problems=3, mean_len=8.0, max_len=12, seed=2)
    ecfg = dict(max_draft=4, block_buckets=(0, 4), max_new_tokens=10)
    jw = JRolloutWorker(JSpecEngine(
        jparams, JCFG, JEngineConfig(**ecfg),
        drafter=JSuffixDrafter(JDrafterConfig(scope="problem"))), jtask, 2)
    batches = [jw.rollout(jtask.problems(), key=jax.random.key(0))]
    for continuous in (False, True):
        w = RolloutWorker(SpecEngine(
            params, CFG, EngineConfig(**ecfg),
            drafter=SuffixDrafter(DrafterConfig(scope="problem")),
            device="cpu"), task, 2, continuous=continuous, slots=2)
        batches.append(w.rollout(task.problems()))
    want = batches[0]
    assert sum(len(r) for r in want.responses) > 0
    for got in batches[1:]:
        assert got.responses == [list(r) for r in want.responses]
        np.testing.assert_array_equal(got.rewards, want.rewards)
        np.testing.assert_array_equal(got.advantages, want.advantages)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.resp_mask, want.resp_mask)
    # The worker options once refused are ported: a watchdog and a
    # journal leave the batch as it was, and a one-worker
    # MultiWorkerRollout hands it back unchanged.
    import tempfile

    from repro_torch.fault import RolloutJournal, RolloutWatchdog
    from repro_torch.rl.rollout import MultiWorkerRollout

    with tempfile.TemporaryDirectory() as d:
        jw2 = RolloutWorker(w.engine, task, 2, continuous=True, slots=2,
                            watchdog=RolloutWatchdog(600.0),
                            journal=RolloutJournal(f"{d}/w.wal"))
        got = jw2.rollout(task.problems())
        jw2.journal.close()
        assert got.responses == [list(r) for r in want.responses]
        sess = RolloutJournal.recover(f"{d}/w.wal")
        assert sorted(sess) == sorted(f"{p.pid}#{g}" for p in task.problems()
                                      for g in range(2))
        assert all(s.finished for s in sess.values())
    got = MultiWorkerRollout([w]).rollout(task.problems())
    assert got.responses == [list(r) for r in want.responses]


def test_unported_trainer_branches_raise(tmp_path):
    """The trainer branches that used to raise build now: two workers
    over the history service (with the supervisor, the journals and the
    flight recorder), and each is closed again."""
    from repro_torch import obs
    from repro_torch.rl.rollout import MultiWorkerRollout

    for over in (dict(n_workers=2), dict(n_workers=2, fault_tolerant=True),
                 dict(journal_dir=str(tmp_path / "j")),
                 dict(flight_recorder=True)):
        tr = Trainer(
            CFG, PatternTask(n_problems=4, mean_len=8.0, max_len=12, seed=0),
            TrainerConfig(**dict(_kw(tmp_path, 1), **over)),
            telemetry=obs.Telemetry(), device="cpu")
        try:
            if over.get("n_workers"):
                assert isinstance(tr.worker, MultiWorkerRollout)
                assert len(tr.engines) == 2 and tr.service is not None
                assert all(e.drafter.remote is not None for e in tr.engines)
                assert all(e.params is tr.params for e in tr.engines)
                assert (tr.supervisor is not None) == bool(
                    over.get("fault_tolerant"))
            if over.get("journal_dir"):
                assert tr.worker.journal is not None
            if over.get("flight_recorder"):
                assert tr.telemetry.flight.enabled
        finally:
            tr.close()
        assert tr.service is None and tr.supervisor is None


def _cli(*args):
    # One OpenMP thread: beside the suite's other workers, each with a
    # thread a core, a child with a thread a core waits in every parallel
    # region on threads that are off the CPU (a 5 s smoke run took over
    # 100 s beside six busy workers on 8 cores).
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def _train_cli_smoke_on_cpu(arch):
    proc = _cli("--arch", arch, "--smoke", "--device", "cpu",
                "--steps", "2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0
               for ln in lines)


def test_train_cli_smoke_on_cpu():
    _train_cli_smoke_on_cpu("qwen2-1.5b")


def test_train_cli_smoke_on_cpu_hybrid():
    _train_cli_smoke_on_cpu("recurrentgemma-9b")


def test_train_cli_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    proc = _cli("--arch", "qwen2-1.5b", "--smoke", "--steps", "1")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    # the dry run needs no card: it counts on meta tensors
    proc = _cli("--arch", "qwen2-1.5b", "--dry-run", "--multi-pod")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rec["status"], rec["shape"], rec["mesh"]) == (
        "ok", "train_4k", "2x16x16")
    assert rec["total_flops"] > 0 and rec["bytes_per_device"] > 0
