"""The port's four examples (``examples/torch_*.py``) against the JAX
package's (``examples/{quickstart,serve_spec,rl_math,rl_code}.py``), in
process on the CPU:

* configs: each torch example's model, task, trainer, engine and drafter
  configs equal the JAX example's field for field (every ``rl_math``
  preset). The JAX example's ``main()`` runs with its ``Trainer`` (or
  ``SpecEngine``) name replaced by a recorder of the arguments, which
  stops it before anything is built;
* outputs, on weights carried from the JAX example's own initial
  weights through numpy: the quickstart's printed lines (decoded
  outputs, both forward counts, ``LOSSLESS``); the serving example's
  forwards and accepted tokens a round; ``rl_math`` (tiny preset) and
  ``rl_code`` at temperature 0, 2 steps after a short SFT warmup, every
  rollout token-identical to the JAX trainer's, rewards equal, the SFT
  cross-entropy within rtol 1e-4 and ``loss``/``grad_norm`` within rtol
  1e-3, atol 1e-5 (``tests/test_torch_train.py``'s tolerances), both 0
  at T 0 (equal samples in each group), so that check confirms a zero
  update;
* the CLIs: each ``main()`` at its smallest settings with ``--device
  cpu`` returns and prints the line ``tests/test_examples.py`` looks for;
  without it (and no card) each exits non-zero naming the card; and the
  quickstart as a subprocess, both ways.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.rl import rollout as jrollout
from repro.rl import trainer as jtrainer
from repro_torch.models.convert import params_from_numpy
from repro_torch.rl import rollout as trollout
from test_torch_chip_smoke import _chip_smoke, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# one intra-op thread for the port's side (``one_torch_thread`` says why)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

_example = _chip_smoke().example


class _Stop(Exception):
    pass


def _recorded(monkeypatch, mod, name, argv, stop):
    """Run ``mod.main()`` under ``argv`` with ``mod.<name>`` replaced by
    a recorder of its calls' arguments; with ``stop`` the first call
    ends the run, else each call goes on to the real ``name``."""
    calls = []
    real = getattr(mod, name)

    def rec(*a, **k):
        calls.append((a, k))
        if stop:
            raise _Stop
        return real(*a, **k)

    monkeypatch.setattr(mod, name, rec)
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    try:
        mod.main()
    except _Stop:
        pass
    return calls


def _same(port, ref, where):
    """``port`` equals ``ref`` on every field of the port's dataclass
    (the reference's may have fields the port does not: ``attn_impl``,
    ``vmem_budget_bytes``)."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same(getattr(port, f.name), getattr(ref, f.name),
                  f"{where}.{f.name}")
    else:
        assert port == ref, f"{where}: {port!r} != {ref!r}"


def _same_task(port, ref):
    assert type(port).__name__ == type(ref).__name__
    pp, rp = port.problems(), ref.problems()
    assert [(p.pid, p.prompt, p.meta) for p in pp] == \
        [(p.pid, p.prompt, p.meta) for p in rp]


def _carried(jparams, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("preset", ["tiny", "10m", "100m"])
def test_rl_math_configs_equal_jax(monkeypatch, preset):
    (a, k), = _recorded(monkeypatch, _example("rl_math"), "Trainer",
                        ["--preset", preset], stop=True)
    mod = _example("torch_rl_math")
    cfg, task, tcfg = mod.configs(mod.parse_args(["--preset", preset]))
    _same(cfg, a[0], "ModelConfig")
    _same_task(task, a[1])
    _same(tcfg, a[2], "TrainerConfig")
    assert mod.PRESETS == _example("rl_math").PRESETS


def test_rl_code_configs_equal_jax(monkeypatch):
    (a, k), = _recorded(monkeypatch, _example("rl_code"), "Trainer", [],
                        stop=True)
    mod = _example("torch_rl_code")
    cfg, task, tcfg = mod.configs(mod.parse_args([]))
    _same(cfg, a[0], "ModelConfig")
    _same_task(task, a[1])
    _same(tcfg, a[2], "TrainerConfig")


def test_quickstart_matches_jax(monkeypatch, capsys):
    """Configs, the printed lines (decoded outputs, both forward counts,
    ``LOSSLESS``) on the JAX example's weights."""
    calls = _recorded(monkeypatch, _example("quickstart"), "SpecEngine", [],
                      stop=False)
    want = capsys.readouterr().out.strip().splitlines()
    mod = _example("torch_quickstart")
    (ja, jk), (da, dk) = calls
    cfg = mod.model_config()
    _same(cfg, ja[1], "ModelConfig")
    base, das, dcfg = mod.engine_configs()
    _same(base, ja[2], "baseline EngineConfig")
    _same(das, da[2], "DAS EngineConfig")
    _same(dcfg, dk["drafter"].cfg, "DrafterConfig")
    lines, (out0, st0), (out1, st1) = mod.quickstart(
        params=_carried(ja[0], cfg), device="cpu")
    assert lines == want
    assert "LOSSLESS" in lines[-1] and out0 == out1
    assert st1.n_fwd < st0.n_fwd


def test_serve_spec_matches_jax(monkeypatch, capsys):
    """Configs, and per round the forwards and accepted tokens (the
    printed lines less their milliseconds) on the JAX example's
    weights."""
    argv = ["--rounds", "3", "--batch", "8"]
    (a, k), = _recorded(monkeypatch, _example("serve_spec"), "SpecEngine",
                        argv, stop=False)
    want = capsys.readouterr().out.strip().splitlines()
    mod = _example("torch_serve_spec")
    cfg = mod.model_config()
    _same(cfg, a[1], "ModelConfig")
    args = mod.parse_args([*argv, "--device", "cpu"])
    ecfg, dcfg = mod.engine_configs(args.max_new)
    _same(ecfg, a[2], "EngineConfig")
    _same(dcfg, k["drafter"].cfg, "DrafterConfig")
    lines, stats = mod.serve_spec(args, params=_carried(a[0], cfg))

    def strip_ms(ln):
        return re.sub(r":\s+[\d.]+ ms", ": ms", ln)

    assert [strip_ms(ln) for ln in lines] == [strip_ms(ln) for ln in want]
    assert len(stats) == 3
    assert stats[-1].acceptance_per_round > stats[0].acceptance_per_round


def _with_tcfg(trainer, over):
    """``trainer`` (a ``Trainer`` class) with ``over``'s fields set on the
    trainer config it is given: ``rl_code`` has no flag for its
    temperature or its SFT warmup, in either package."""

    class Over(trainer):
        def __init__(self, cfg, task, tcfg, **kw):
            for f, v in over.items():
                setattr(tcfg, f, v)
            super().__init__(cfg, task, tcfg, **kw)

    return Over


def _jax_rl_run(monkeypatch, name, argv, tcfg_over):
    """The JAX example's run with every rollout's responses, the SFT
    warmup's final CE and the trainer's initial weights recorded."""
    mod = _example(name)
    rec = {"rolls": [], "sft": []}

    class Rec(_with_tcfg(jtrainer.Trainer, tcfg_over)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["params"] = self.params

        def run(self, *a, **k):
            rec["hist"] = super().run(*a, **k)
            return rec["hist"]

    real_rollout = jrollout.RolloutWorker.rollout
    real_sft = jtrainer.Trainer.sft_warmup

    def rollout(self, *a, **k):
        batch = real_rollout(self, *a, **k)
        rec["rolls"].append([list(map(int, r)) for r in batch.responses])
        return batch

    def sft(self, *a, **k):
        rec["sft"].append(real_sft(self, *a, **k))
        return rec["sft"][-1]

    monkeypatch.setattr(jrollout.RolloutWorker, "rollout", rollout)
    monkeypatch.setattr(jtrainer.Trainer, "sft_warmup", sft)
    monkeypatch.setattr(mod, "Trainer", Rec)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return rec


def _port_rollouts(monkeypatch):
    rolls = []
    real = trollout.RolloutWorker.rollout

    def rollout(self, *a, **k):
        batch = real(self, *a, **k)
        rolls.append([list(map(int, r)) for r in batch.responses])
        return batch

    monkeypatch.setattr(trollout.RolloutWorker, "rollout", rollout)
    return rolls


def _held_to_jax(jrec, rolls, hist, tr):
    """The port's run against the JAX run's record. At T 0 a GRPO group's
    samples are equal, so every advantage, ``loss`` and ``grad_norm`` is 0
    on both sides: their comparison confirms a zero update, no more
    (``tests/test_torch_grpo.py`` holds the GRPO step to JAX on non-zero
    advantages)."""
    assert rolls == jrec["rolls"], "rollouts differ from the JAX trainer's"
    assert len(rolls) == 2 and sum(len(r) for rs in rolls for r in rs) > 0
    np.testing.assert_allclose(tr.sft_losses[-1], jrec["sft"][-1],
                               rtol=1e-4)
    jh = jrec["hist"]
    assert len(hist) == len(jh) == 2
    for a, b in zip(hist, jh):
        assert a["reward_mean"] == b["reward_mean"]
        assert a["n_fwd"] == b["n_fwd"]
        assert a["grad_norm"] == 0, "a T 0 group with a non-zero advantage"
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-3, atol=1e-5,
                                       err_msg=key)


def test_rl_math_matches_jax_at_t0(monkeypatch):
    argv = ["--steps", "2", "--sft-warmup", "2", "--max-new", "24",
            "--temperature", "0"]
    jrec = _jax_rl_run(monkeypatch, "rl_math", argv, {})
    rolls = _port_rollouts(monkeypatch)
    mod = _example("torch_rl_math")
    args = mod.parse_args([*argv, "--device", "cpu"])
    cfg, _, _ = mod.configs(args)
    lines, hist, tr = mod.rl_math(args, params=_carried(jrec["params"], cfg))
    _held_to_jax(jrec, rolls, hist, tr)
    assert lines[-1].startswith("# total rollout time:")


def test_rl_code_matches_jax_at_t0(monkeypatch):
    over = dict(temperature=0.0, sft_warmup_steps=3)
    jrec = _jax_rl_run(monkeypatch, "rl_code", ["--steps", "2"], over)
    rolls = _port_rollouts(monkeypatch)
    mod = _example("torch_rl_code")
    monkeypatch.setattr(mod, "Trainer", _with_tcfg(mod.Trainer, over))
    args = mod.parse_args(["--steps", "2", "--device", "cpu"])
    cfg, _, _ = mod.configs(args)
    lines, hist, tr = mod.rl_code(args, params=_carried(jrec["params"], cfg))
    _held_to_jax(jrec, rolls, hist, tr)
    assert lines[-1].startswith("# final reward:")


CLIS = [
    ("torch_quickstart", [], "LOSSLESS"),
    ("torch_serve_spec", ["--rounds", "2", "--batch", "2", "--max-new", "8"],
     "round 1"),
    ("torch_rl_math", ["--steps", "1", "--sft-warmup", "1", "--max-new",
                       "8"], "total rollout time"),
    ("torch_rl_code", ["--steps", "1"], "final reward"),
]


@pytest.mark.parametrize("name,args,line", CLIS, ids=[c[0] for c in CLIS])
def test_cli_on_the_cpu_and_without_a_card(monkeypatch, capsys, name, args,
                                           line):
    """The CLI (``main()`` under its arguments, in process) with
    ``--device cpu`` returns and prints its line; with the default device
    and no card it exits non-zero naming the card and prints nothing."""
    mod = _example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args, "--device",
                                      "cpu"])
    mod.main()
    assert line in capsys.readouterr().out
    if torch.cuda.is_available():
        return  # a card is visible: the default device exists
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    with pytest.raises(SystemExit) as e:
        mod.main()
    assert e.value.code not in (0, None)
    assert "needs a CUDA card" in str(e.value.code)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_cli_runs_as_a_script():
    """``python examples/torch_quickstart.py --device cpu`` exits 0 and
    prints ``LOSSLESS``; without ``--device cpu`` and no card, 1 and the
    card's name on stderr (one OpenMP thread, as beside the suite's other
    workers)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "examples/torch_quickstart.py"]
    runs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for c in ([*cmd, "--device", "cpu"], cmd)]
    try:
        (out, err), (out2, err2) = [p.communicate(timeout=240) for p in runs]
    finally:
        for p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert runs[0].returncode == 0, err[-2000:]
    assert "LOSSLESS" in out
    if torch.cuda.is_available():
        return  # a card is visible: the default device exists
    assert runs[1].returncode == 1 and not out2
    assert "needs a CUDA card" in err2
