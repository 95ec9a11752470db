"""The port's multi-worker trainer against the JAX trainer, on the CPU
(the tiny Qwen2-1.5B-shaped config and pattern task of
``tests/test_torch_train.py``, T = 0, no SFT so the steps stay short):

* ``Trainer`` with ``n_workers = 2`` over the in-process sharded history
  service, against the JAX ``Trainer`` with the same config and weights:
  every step's rollouts, rewards, drafted and accepted counts, and
  ``MultiWorkerRollout.stats`` equal (the third step drafts from the
  pooled history of the first two);
* the fault-tolerant trainer with a ``FlakyWorker`` (worker 1 stalls on
  its first call; its slice re-queues to worker 0) and a shard killed
  by a seeded ``FaultPlan`` hook after its second publish (the
  supervisor restarts it), against the JAX trainer with the same faults:
  every step's rollouts, rewards, drafted and accepted counts and rounds,
  and ``MultiWorkerRollout.stats`` equal; token-identical to the
  fault-free run, the shard restarted, the fault fired;
* a multi-worker checkpoint (the shards' states in the sidecar) resumes
  token-identical to the uninterrupted run.
"""

import jax
import numpy as np
import pytest

from conftest import make_params
from repro.core.drafter import DrafterConfig as JDrafterConfig
from repro.core.spec_engine import EngineConfig as JEngineConfig
from repro.data.tasks import PatternTask as JPatternTask
from repro.fault import FaultPlan as JFaultPlan
from repro.fault import FlakyWorker as JFlakyWorker
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.rl.trainer import Trainer as JTrainer
from repro.rl.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core.drafter import DrafterConfig
from repro_torch.core.spec_engine import EngineConfig
from repro_torch.data.tasks import PatternTask
from repro_torch.fault import FaultPlan, FlakyWorker
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rl.trainer import Trainer, TrainerConfig
from test_torch_train import CFG, JCFG

TASK = dict(n_problems=4, mean_len=8.0, sigma=0.3, max_len=12, seed=0)
ENG = dict(max_draft=4, block_buckets=(0, 4))
DRAFT = dict(scope="problem", window_size=4, min_match=1)
STEPS = 3


def _kw(path, **over):
    kw = dict(steps=STEPS, prompts_per_step=2, group_size=2,
              max_new_tokens=12, temperature=0.0, seed=11,
              sft_warmup_steps=0, n_workers=2, history_shards=2,
              ckpt_path=str(path), ckpt_every=0, supervise_interval_s=0.0)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def weights():
    jparams = make_params(JCFG, seed=3)
    return jparams, jax.tree.map(np.asarray, jparams)


def _port_trainer(weights, path, **over):
    return Trainer(
        CFG, PatternTask(**TASK),
        TrainerConfig(optim=AdamWConfig(lr=1e-3),
                      engine=EngineConfig(**ENG),
                      drafter=DrafterConfig(**DRAFT), **_kw(path, **over)),
        params=params_from_numpy(weights[1], CFG, "cpu"), device="cpu")


def _capture(tr, log):
    orig = tr.worker.rollout

    def wrapped(*a, **k):
        batch = orig(*a, **k)
        log.append(([list(r) for r in batch.responses],
                    batch.rewards.tolist(), batch.stats.n_drafted,
                    batch.stats.n_accepted, batch.stats.n_rounds))
        return batch

    tr.worker.rollout = wrapped


def _run(tr, steps=None):
    log = []
    _capture(tr, log)
    try:
        hist = tr.run(steps)
    finally:
        tr.close()
    return log, hist


def _jax_trainer(weights, path, **over):
    return JTrainer(
        JCFG, JPatternTask(**TASK),
        JTrainerConfig(optim=JAdamWConfig(lr=1e-3),
                       engine=JEngineConfig(**ENG),
                       drafter=JDrafterConfig(**DRAFT),
                       **_kw(path, **over)),
        params=weights[0])


def _inject(tr, plan_cls, flaky_cls):
    """Shard 1 killed by its hook after its second publish, worker 1
    stalled on its first call; returns the plan."""
    plan = plan_cls(seed=0).kill_shard(1, op="publish", at=2)
    for i, srv in enumerate(tr.service.servers):
        srv.fault_hook = plan.server_hook(i)
    mw = tr.worker
    mw.workers[1] = flaky_cls(mw.workers[1], fail_calls=(0,))
    return plan


@pytest.fixture(scope="module")
def fault_free(weights, tmp_path_factory):
    """The port's fault-free two-worker run: its log, history and
    ``MultiWorkerRollout.stats``."""
    tr = _port_trainer(weights, tmp_path_factory.mktemp("free"))
    log, hist = _run(tr)
    return log, hist, dict(tr.worker.stats)


def test_two_workers_match_jax_trainer(weights, fault_free, tmp_path):
    jtr = _jax_trainer(weights, tmp_path / "j")
    jlog, jh = _run(jtr)
    log, h, stats = fault_free
    assert len(log) == len(jlog) == STEPS
    assert log == jlog, "rollouts/rewards/drafted/accepted differ"
    assert sum(x[3] for x in log) > 0, "pooled history must be drafted from"
    assert stats == dict(jtr.worker.stats)
    for a, b in zip(h, jh):
        assert a["reward_mean"] == b["reward_mean"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3,
                                   atol=1e-5)


def test_fault_tolerant_run_is_token_identical(weights, fault_free,
                                               tmp_path):
    want = fault_free[0]
    over = dict(fault_tolerant=True)
    jtr = _jax_trainer(weights, tmp_path / "j",
                       journal_dir=str(tmp_path / "j" / "jrnl"), **over)
    jplan = _inject(jtr, JFaultPlan, JFlakyWorker)
    jmw, jsup = jtr.worker, jtr.supervisor
    jlog, _ = _run(jtr)
    tr = _port_trainer(weights, tmp_path / "b",
                       journal_dir=str(tmp_path / "b" / "jrnl"), **over)
    plan = _inject(tr, FaultPlan, FlakyWorker)
    mw, sup = tr.worker, tr.supervisor
    got, _ = _run(tr)
    assert len(got) == len(jlog) == STEPS
    assert got == jlog, "rollouts/rewards/drafted/accepted/rounds differ " \
        "from the JAX trainer's under the same faults"
    assert dict(mw.stats) == dict(jmw.stats)
    assert plan.fired == jplan.fired
    assert sup.stats["restarts"] == jsup.stats["restarts"] >= 1
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [f["action"] for f in plan.fired] == ["kill"]
    assert mw.stats["worker_failures"] == 1
    assert mw.stats["requeued_problems"] == 1


def test_multiworker_checkpoint_resumes_token_identical(weights, tmp_path):
    want, hist = _run(_port_trainer(weights, tmp_path / "a",
                                    ckpt_every=2))
    from repro_torch.checkpoint import load_sidecar

    path = str(tmp_path / "a" / "step2.npz")
    shards = load_sidecar(path)["history_service"]["shards"]
    assert len(shards) == 2 and any(st["store"]["problems"] for st in shards)
    tr = _port_trainer(weights, tmp_path / "a")
    tr.load_checkpoint(path)
    assert tr._step == 2 and tr.service is not None
    got, hist_b = _run(tr)
    assert got == want[2:]
    assert [h["reward_mean"] for h in hist_b[2:]] == \
        [h["reward_mean"] for h in hist[2:]]


def _serve_cli(*args, timeout=300, env_extra=None):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)


def test_serve_cli_with_service_journal_metrics_and_trace(tmp_path):
    """``launch.serve`` with the flags it once refused: two workers over
    subprocess shards, supervised, continuous, journals, a metrics
    endpoint and a trace; the trace validates and every journal session
    finished. A second run over the same journal directory recovers it.
    ``--dry-run --shape verify_8`` counts the full config's verify step
    without a card and prints its record."""
    import json

    from repro_torch import obs
    from repro_torch.fault import RolloutJournal

    d = tmp_path / "j"
    args = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
            "--continuous", "--history-service", "--workers", "2",
            "--shards", "2", "--supervise", "--scope", "problem",
            "--rounds", "1", "--requests", "4", "--slots", "2",
            "--journal-dir", str(d), "--trace-out", str(d / "trace.json"),
            "--metrics-port", "0", "--log-every", "1"]
    proc = _serve_cli(*args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "metrics at http://127.0.0.1:" in proc.stderr
    doc = json.loads((d / "trace.json").read_text())
    assert doc["traceEvents"] and obs.validate_chrome_trace(doc) == []
    for w in range(2):
        sess = RolloutJournal.recover(str(d / f"w{w}.wal"))
        assert sess and all(s.finished for s in sess.values())
    # single-worker serving with a journal and the history flags
    h = tmp_path / "h"
    args1 = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
             "--continuous", "--scope", "problem", "--rounds", "1",
             "--requests", "4", "--slots", "2", "--journal-dir", str(h),
             "--history-dir", str(h), "--save-history"]
    for _ in range(2):  # the second start recovers and warm-starts
        proc = _serve_cli(*args1)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert "journal recovery" in proc.stderr and "warm start" in proc.stderr
    proc = _serve_cli("--arch", "qwen2-1.5b", "--dry-run", "--shape",
                      "verify_8", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rec["status"], rec["shape"], rec["mesh"]) == (
        "ok", "verify_8", "16x16")
    assert rec["kernel_launches"] == {"spec_verify_attention": 28}
