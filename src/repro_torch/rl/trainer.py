"""Actor–learner RL trainer of the port (counterpart of
``repro.rl.trainer``), on the single-worker path.

Per step: rollout (speculative or baseline) → verifiable rewards →
group advantages → GRPO update → drafter window refresh keyed by the
optimizer's update norm (paper §4.1.2). The drafter needs *no
retraining* after policy updates — that is the paper's central systems
claim. The policy is one ``Transformer`` shared by the learner and the
engine: the AdamW step writes its parameters in place.

Checkpoints carry the full resumable state: parameters and optimizer in
the ``.npz``, and — in the versioned sidecar — the rollout-history store
(drafter windows + telemetry), length-policy history, the training
generator's state, loader cursor and step/epoch cursor.
``load_checkpoint`` therefore resumes with warm suffix trees and warm
length priors, and a resumed run draws what the uninterrupted one drew.

It trains every model the port runs, the hybrid RecurrentGemma included
(the RG-LRU scan's gradient is its backward kernel). Not ported yet
(they raise ``NotImplementedError``): the multi-worker
rollout over the history service (``n_workers > 1``), the shard
supervisor (``fault_tolerant``), the write-ahead journal
(``journal_dir``) and the flight recorder (``flight_recorder``).
Graceful drain is ported: with ``graceful_drain`` (the default),
SIGTERM/SIGINT make ``run()`` finish the step in flight, checkpoint
(``ckpt_path`` permitting) and return.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.length_policy import LengthPolicy
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.data.loader import PromptLoader
from repro_torch.data.tasks import Task
from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.rl.grpo import (
    GRPOConfig,
    compute_old_logprobs,
    make_sft_step,
    make_train_step,
)
from repro_torch.rl.rollout import RolloutWorker


@dataclass
class TrainerConfig:
    steps: int = 30
    prompts_per_step: int = 8
    group_size: int = 4
    max_new_tokens: int = 64
    temperature: float = 0.0
    seed: int = 0
    # substrate configs
    grpo: GRPOConfig = field(default_factory=GRPOConfig)
    optim: adamw.AdamWConfig = field(
        default_factory=lambda: adamw.AdamWConfig(lr=1e-3))
    engine: EngineConfig = field(default_factory=EngineConfig)
    drafter: DrafterConfig = field(default_factory=DrafterConfig)
    ckpt_path: str = ""
    ckpt_every: int = 0
    # SFT warmup: stands in for the pretrained checkpoint the paper
    # post-trains; 0 disables.
    sft_warmup_steps: int = 0
    sft_lr: float = 3e-3
    # Multi-worker rollout over the history service and its fault
    # tolerance (not ported yet: n_workers > 1 and fault_tolerant raise;
    # the reference's history_shards, watchdog_deadline_s and
    # supervise_interval_s tune only those paths and are left out).
    n_workers: int = 1
    fault_tolerant: bool = False
    # Durability: journal_dir (not ported yet: non-empty raises).
    # graceful_drain installs SIGTERM/SIGINT handlers in run(): the step
    # in flight finishes, a checkpoint is written (ckpt_path permitting),
    # and run() returns instead of dying mid-update.
    journal_dir: str = ""
    graceful_drain: bool = True
    drain_deadline_s: float = 30.0
    # Flight recorder (not ported yet: True raises).
    flight_recorder: bool = False


def _refuse_unported(tcfg: TrainerConfig) -> None:
    for what, on in (
            ("n_workers > 1 (the multi-worker rollout over the history "
             "service)", tcfg.n_workers > 1),
            ("fault_tolerant (the shard supervisor)", tcfg.fault_tolerant),
            ("journal_dir (the write-ahead rollout journal)",
             bool(tcfg.journal_dir)),
            ("flight_recorder", tcfg.flight_recorder)):
        if on:
            raise NotImplementedError(
                f"TrainerConfig {what} is not ported to repro_torch yet")


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        task: Task,
        tcfg: TrainerConfig,
        params: Optional[M.Transformer] = None,
        telemetry=None,
        device=None,
    ) -> None:
        from repro_torch import obs

        _refuse_unported(tcfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.task = task
        self.tcfg = tcfg
        self.telemetry = (
            telemetry if telemetry is not None else obs.get_telemetry()
        )
        if params is None:
            params = M.init_params(cfg, seed=tcfg.seed, device=self.device)
        self.params = M.set_trainable(params)
        self.opt_state = adamw.init_state(self.params)
        tcfg.engine.temperature = tcfg.temperature
        tcfg.engine.max_new_tokens = tcfg.max_new_tokens
        self.drain = None  # DrainController, installed by run()
        self.engine = SpecEngine(
            self.params, cfg, tcfg.engine,
            drafter=SuffixDrafter(tcfg.drafter),
            length_policy=LengthPolicy(),
            device=self.device,
        )
        self.worker = RolloutWorker(self.engine, self.task, tcfg.group_size)
        self.loader = PromptLoader(task, tcfg.prompts_per_step, seed=tcfg.seed)
        gcfg = GRPOConfig(
            clip_eps=tcfg.grpo.clip_eps, kl_coef=tcfg.grpo.kl_coef,
            entropy_coef=tcfg.grpo.entropy_coef, group_size=tcfg.group_size,
            remat=tcfg.grpo.remat,
        )
        self._train_step = make_train_step(cfg, gcfg, tcfg.optim)
        self.history: List[Dict[str, Any]] = []
        self.sft_losses: List[float] = []  # CE of each SFT warmup step
        # Resumable cursor (persisted in the checkpoint sidecar).
        self._step = 0
        self._epoch = 0
        self._batch_idx = 0  # next batch within the current epoch
        self._update_norm = 0.0
        self._gen: Optional[torch.Generator] = None  # made lazily in run()
        self._epoch_begun = -1  # last epoch begin_iteration ran for
        self._epoch_batches = None  # (epoch, [batches]) shuffle cache

    def close(self) -> None:
        """Uninstall the drain handlers (nothing else is held open on the
        single-worker path)."""
        if self.drain is not None:
            self.drain.uninstall()
            self.drain = None

    def _tensor(self, arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr), device=self.device)

    def sft_warmup(self, steps: Optional[int] = None) -> float:
        """Supervised warmup on task target responses (pretraining
        stand-in, see TrainerConfig.sft_warmup_steps). Returns final CE."""
        tcfg = self.tcfg
        n = steps if steps is not None else tcfg.sft_warmup_steps
        if n <= 0:
            return float("nan")
        ocfg = adamw.AdamWConfig(lr=tcfg.sft_lr, warmup_steps=2)
        sft_step = make_sft_step(self.cfg, ocfg)
        opt = adamw.init_state(self.params)
        probs = self.loader.problems
        # static batch: all problems with their expected responses
        seqs = [list(p.prompt) + list(self.task.expected_response(p)) + [EOS]
                for p in probs]
        S = ((max(len(s) for s in seqs) + 31) // 32) * 32
        tok = np.full((len(probs), S), PAD, np.int32)
        rmask = np.zeros((len(probs), S), bool)
        for i, (p, seq) in enumerate(zip(probs, seqs)):
            tok[i, : len(seq)] = seq
            rmask[i, len(p.prompt) : len(seq)] = True
        batch = {"tokens": self._tensor(tok), "resp_mask": self._tensor(rmask)}
        loss = float("nan")
        self.sft_losses = []
        for _ in range(n):
            self.params, opt, m = sft_step(self.params, opt, batch)
            loss = float(m["sft_loss"])
            self.sft_losses.append(loss)
        self.engine.set_params(self.params)
        return loss

    def run(self, steps: Optional[int] = None) -> List[Dict[str, Any]]:
        tcfg = self.tcfg
        n_steps = steps or tcfg.steps
        if self.drain is None and tcfg.graceful_drain:
            from repro_torch.fault.drain import DrainController

            # SIGTERM/SIGINT → finish the step in flight, checkpoint,
            # return (instead of dying mid-update). install() is a
            # no-op off the main thread; explicit drain.request() still
            # works there.
            self.drain = DrainController(
                tcfg.drain_deadline_s, telemetry=self.telemetry
            ).install()
        if tcfg.sft_warmup_steps > 0 and not self.history and self._step == 0:
            self.sft_warmup()
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(
                tcfg.seed + 1)
        while self._step < n_steps:
            if self._epoch_begun != self._epoch:
                # Once per epoch — a mid-epoch resume must not re-run
                # the refresh the uninterrupted run did once (the
                # checkpointed store already reflects it).
                self.engine.begin_iteration(self._epoch, self._update_norm)
                self._epoch_begun = self._epoch
            resume_at = self._batch_idx
            epoch_done = True
            # One shuffle per epoch: a mid-epoch re-entry (run() called
            # again on the same trainer) must fast-forward over the SAME
            # permutation; the cross-process path (load_checkpoint)
            # clears this cache and relies on loader.seek().
            if (
                self._epoch_batches is None
                or self._epoch_batches[0] != self._epoch
            ):
                self._epoch_batches = (
                    self._epoch,
                    list(self.loader.epoch_batches(self._epoch)),
                )
            for bi, problems in enumerate(self._epoch_batches[1]):
                if bi < resume_at:
                    continue  # fast-forward after a mid-epoch resume
                if self._step >= n_steps:
                    epoch_done = False
                    break
                if self.drain is not None and self.drain.draining:
                    epoch_done = False
                    break
                batch = self.worker.rollout(
                    problems, generator=self._gen,
                    max_new_tokens=tcfg.max_new_tokens,
                )
                t0 = time.perf_counter()
                tokens = self._tensor(batch.tokens)
                train_batch = {
                    "tokens": tokens,
                    "resp_mask": self._tensor(batch.resp_mask),
                    "advantages": self._tensor(batch.advantages),
                    "old_logprobs": compute_old_logprobs(
                        self.params, self.cfg, tokens),
                }
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, train_batch
                )
                loss = float(metrics["loss"])  # waits for the step
                train_time = time.perf_counter() - t0
                self._update_norm = float(metrics["update_norm"])
                self.engine.set_params(self.params)
                rec = {
                    "step": self._step,
                    "epoch": self._epoch,
                    "reward_mean": float(batch.rewards.mean()),
                    "reward_max": float(batch.rewards.max()),
                    "gen_time_s": batch.gen_time_s,
                    "train_time_s": train_time,
                    "n_fwd": batch.stats.n_fwd,
                    "n_toks_proposed": batch.stats.n_toks_proposed,
                    "accept_per_round": batch.stats.acceptance_per_round,
                    "emitted_per_fwd": batch.stats.mean_accepted_per_fwd,
                    "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                }
                self.history.append(rec)
                if self.telemetry.enabled:
                    self._note_step_obs(rec)
                self._step += 1
                self._batch_idx = bi + 1
                if (
                    tcfg.ckpt_every
                    and self._step % tcfg.ckpt_every == 0
                    and tcfg.ckpt_path
                ):
                    self.save_checkpoint(
                        f"{tcfg.ckpt_path}/step{self._step}.npz"
                    )
            if epoch_done:
                self._epoch += 1
                self._batch_idx = 0
            if self.drain is not None and self.drain.draining:
                # Checkpoint-and-exit: the cursor sidecar makes the next
                # run() resume at the exact batch we stopped before.
                if tcfg.ckpt_path:
                    self.save_checkpoint(
                        f"{tcfg.ckpt_path}/drain_step{self._step}.npz"
                    )
                break
        return self.history

    def _note_step_obs(self, rec: Dict[str, Any]) -> None:
        """Per-iteration telemetry rollup: last-step gauges + one
        ``train_step`` event."""
        reg = self.telemetry.registry
        gauges = {
            "das_train_step": ("Last completed trainer step", "step"),
            "das_train_reward_mean": (
                "Mean reward of the last rollout batch", "reward_mean"),
            "das_train_loss": ("Last GRPO loss", "loss"),
            "das_train_gen_seconds": (
                "Rollout wall time of the last step", "gen_time_s"),
            "das_train_update_seconds": (
                "Train-step wall time of the last step", "train_time_s"),
            "das_train_accept_per_round": (
                "Mean accepted tokens per round, last step",
                "accept_per_round"),
        }
        for name, (help_, field_) in gauges.items():
            reg.gauge(name, help_).set(float(rec[field_]))
        self.telemetry.emit(
            "train_step", step=rec["step"], epoch=rec["epoch"],
            reward_mean=rec["reward_mean"], loss=rec["loss"],
            gen_time_s=rec["gen_time_s"], train_time_s=rec["train_time_s"],
        )

    # -- persistence -------------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        """Full resumable checkpoint: weights + optimizer in the npz,
        rollout history / length policy / generator / cursor in the
        sidecar."""
        from repro_torch.checkpoint import save
        from repro_torch.history import persist

        sidecar = {
            "history": persist.engine_state(self.engine),
            "history_service": None,  # no multi-worker path yet
            "cursor": {
                "step": self._step,
                "epoch": self._epoch,
                "batch_idx": self._batch_idx,
                "update_norm": self._update_norm,
                # Draws made *before* the current epoch's shuffle: the
                # resumed run() re-draws the current epoch itself, so a
                # mid-epoch checkpoint (batch_idx > 0) excludes it.
                "loader_draws": self.loader._draws
                - (1 if self._batch_idx > 0 else 0),
            },
            "rng": (
                None if self._gen is None
                else self._gen.get_state().tolist()
            ),
            "metrics": self.history,
        }
        save(
            path,
            {"params": self.params, "opt": self.opt_state},
            metadata={"step": self._step, "epoch": self._epoch},
            sidecar=sidecar,
        )
        return path

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint`` output: restores weights (in
        place), optimizer, rollout-history store (suffix trees rebuilt
        warm from the persisted windows), length priors, the generator
        state and the step/epoch/loader cursor. At temperature 0 the
        resumed run's rollouts are token-identical to an uninterrupted
        run's."""
        from repro_torch.checkpoint import load, load_sidecar
        from repro_torch.history import persist

        tree, _ = load(path, {"params": self.params, "opt": self.opt_state})
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        sc = load_sidecar(path)
        if sc.get("history_service") is not None:
            raise NotImplementedError(
                f"{path}: a multi-worker checkpoint (history service "
                "shards) cannot be resumed by repro_torch yet"
            )
        persist.restore_engine(self.engine, sc["history"])
        self.engine.set_params(self.params)
        cur = sc["cursor"]
        self._step = int(cur["step"])
        self._epoch = int(cur["epoch"])
        self._batch_idx = int(cur["batch_idx"])
        # Mid-epoch checkpoint: the epoch's begin_iteration already ran
        # before the save (its effects are in the restored store) — the
        # resumed run must not repeat it.
        self._epoch_begun = self._epoch if self._batch_idx > 0 else -1
        self._epoch_batches = None  # loader.seek() reproduces the shuffle
        self._update_norm = float(cur["update_norm"])
        self.loader.seek(int(cur["loader_draws"]))
        self._gen = None
        if sc["rng"] is not None:
            self._gen = torch.Generator(device=self.device)
            self._gen.set_state(torch.tensor(sc["rng"], dtype=torch.uint8))
        self.history = list(sc["metrics"])
