"""Persistence for the rollout-history subsystem.

Saves/loads the ``RolloutHistoryStore`` + drafter configuration +
``LengthPolicy`` state as one JSON document, either standalone
(``save_history``/``load_history`` — the ``--history-dir`` format used
by ``launch/serve.py``) or embedded as a checkpoint sidecar blob next to
the model weights (``engine_state``/``restore_engine`` — used by
``rl/trainer.py`` through ``checkpoint.ckpt``'s sidecar channel).

A resumed RL run, or a fresh serving process pointed at a history dir,
starts with **warm trees and warm length priors**: suffix trees are
rebuilt from the persisted windows (the verified rebuild path — query-
equivalent to the live trees the original process maintained
incrementally) and the length policy replays the recorded per-problem
response lengths, so the scheduler's longest-predicted-first admission
and the budget solver are history-aware from the first request.

The sharded history service persists through the same module: a
**shard manifest** (``history_manifest.json``) listing one
``history.shard<k>.json`` snapshot per shard — ``save_service_history``
/ ``load_service_history`` — so a checkpoint resume or a
``--history-dir`` warm start restores every shard of the fleet.

Every payload carries ``schema_version``; loads fail loudly on an
*unknown* schema rather than silently mis-reading a foreign blob.
Schema 2 (current) added the shard manifest + shard snapshot kinds;
schema-1 payloads (single-store ``history.json``) still load, and the
shard loader treats a legacy ``history.json`` with no manifest as shard
0 of 1. All writes are crash-safe: tmp file + fsync + atomic rename
(+ directory fsync), so a torn save can never corrupt the previous
history.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Sequence

from .store import RolloutHistoryStore

log = logging.getLogger("repro_torch.history.persist")

SCHEMA_VERSION = 2
LEGACY_SCHEMA_VERSIONS = (1,)
HISTORY_FILENAME = "history.json"
MANIFEST_FILENAME = "history_manifest.json"
QUARANTINE_SUFFIX = ".corrupt"


class HistorySchemaError(RuntimeError):
    """Raised when a persisted history blob has the wrong schema."""


class HistoryCorruptError(HistorySchemaError):
    """Raised when a persisted history file is unreadable (truncated /
    garbled JSON, or not a history payload at all). The offending file
    has already been quarantined by the time this propagates. Subclasses
    ``HistorySchemaError``: corrupt bytes are the extreme case of "not a
    loadable history payload", so callers guarding loads with
    ``except HistorySchemaError`` keep rejecting them."""


def _quarantine(path: str, reason: str) -> str:
    """Move a corrupt history file aside (``<name>.corrupt``) so the
    next save — and the next load — start clean, while the bytes stay
    on disk for post-mortem. Returns the quarantine path."""
    qpath = path + QUARANTINE_SUFFIX
    try:
        os.replace(path, qpath)
    except OSError:
        qpath = path  # unremovable (perms?) — leave in place, still loud
    log.warning(
        "history file %s is corrupt (%s); quarantined to %s — the shard "
        "cold-starts and will re-warm from the fleet's rollout stream",
        path, reason, qpath,
    )
    return qpath


def _load_checked_json(path: str, *, kind: str = "payload") -> Dict[str, Any]:
    """Read + schema-check one history JSON file; corrupt bytes or a
    non-history document quarantine the file and raise
    ``HistoryCorruptError``. A *well-formed* payload from a FUTURE
    schema is NOT corruption — it raises ``HistorySchemaError`` and
    stays on disk untouched (a newer build's valid data must survive a
    rollback)."""
    try:
        with open(path) as f:
            state = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        _quarantine(path, f"unparseable JSON: {exc}")
        raise HistoryCorruptError(f"{path}: unparseable {kind}") from exc
    if not isinstance(state, dict) or "schema_version" not in state:
        _quarantine(path, "not a history payload (missing schema_version)")
        raise HistoryCorruptError(
            f"{path}: not a history {kind} (missing schema_version)"
        )
    _check_schema(state, path)  # unknown future schema: raise, no quarantine
    return state


def _check_schema(state: Dict[str, Any], origin: str) -> None:
    if not isinstance(state, dict) or "schema_version" not in state:
        raise HistorySchemaError(
            f"{origin}: not a history payload (missing schema_version)"
        )
    v = state["schema_version"]
    if v != SCHEMA_VERSION and v not in LEGACY_SCHEMA_VERSIONS:
        raise HistorySchemaError(
            f"{origin}: schema_version {v} not supported (current "
            f"{SCHEMA_VERSION}, legacy {list(LEGACY_SCHEMA_VERSIONS)}); "
            "re-save the history with this build or upgrade the loader"
        )


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> str:
    """Crash-safe JSON write: tmp + flush + fsync + atomic rename, then
    fsync the directory so the rename itself survives a power cut. A
    plain ``open(path, 'w')`` could leave a torn file on crash."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: a crashed save never corrupts history
    try:
        dfd = os.open(os.path.dirname(path), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # not all platforms/filesystems support directory fsync
    return path


# -- state assembly --------------------------------------------------------
def drafter_state(drafter) -> Dict[str, Any]:
    return {
        "cfg": asdict(drafter.cfg),
        "epoch": drafter.epoch,
        "window_size": drafter._window_size,
        "stats": dict(drafter.stats),
    }


def history_state(
    *,
    store: Optional[RolloutHistoryStore] = None,
    drafter=None,
    length_policy=None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble one JSON-able payload. ``store`` defaults to the
    drafter's own store when omitted."""
    if store is None and drafter is not None:
        store = drafter.store
    state: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "meta": dict(meta or {}),
    }
    if store is not None:
        state["store"] = store.state_dict()
    if drafter is not None:
        state["drafter"] = drafter_state(drafter)
    if length_policy is not None:
        state["length_policy"] = length_policy.state_dict()
    return state


def engine_state(engine, meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """History payload for a ``SpecEngine`` (drafter + store + lengths)."""
    return history_state(
        drafter=engine.drafter,
        length_policy=engine.length_policy,
        meta=meta,
    )


# -- restore ---------------------------------------------------------------
def warm_drafter(drafter, state: Dict[str, Any], build_trees: bool = True):
    """Load persisted history into an existing drafter.

    Replaces the drafter's store, restores its epoch/window cursor and
    (optionally) eagerly rebuilds every per-problem tree from the
    persisted windows so the first request drafts against warm history.
    """
    _check_schema(state, "warm_drafter")
    d = state.get("drafter")
    if d is not None:
        drafter.epoch = int(d.get("epoch", drafter.epoch))
        # The persisted window size is transient *adaptive* state (it
        # tracks update norms); only restore it when adaptation is on —
        # otherwise the configured window wins, so an operator raising
        # window_size over a persisted history actually gets it.
        if drafter.cfg.adapt_window_to_updates:
            drafter._window_size = int(
                d.get("window_size", drafter._window_size)
            )
        drafter.stats.clear()  # replace, like every other restored field
        drafter.stats.update(d.get("stats", {}))
    if "store" in state:
        drafter.load_store(RolloutHistoryStore.from_state(state["store"]))
    if build_trees:
        drafter.warm_trees()
    return drafter


def warm_length_policy(length_policy, state: Dict[str, Any]):
    """Restore length history: explicit policy state when persisted,
    else replayed from the store's recorded response lengths."""
    _check_schema(state, "warm_length_policy")
    if "length_policy" in state:
        length_policy.load_state_dict(state["length_policy"])
    elif "store" in state:
        store = RolloutHistoryStore.from_state(state["store"])
        store.warm_length_policy(length_policy)
    return length_policy


def restore_engine(engine, state: Dict[str, Any], build_trees: bool = True):
    """Warm a ``SpecEngine`` (drafter store + trees + length priors)."""
    _check_schema(state, "restore_engine")
    warm_drafter(engine.drafter, state, build_trees=build_trees)
    warm_length_policy(engine.length_policy, state)
    engine.epoch = engine.drafter.epoch
    return engine


def restore_drafter(state: Dict[str, Any], build_trees: bool = True):
    """Construct a fresh ``SuffixDrafter`` from a persisted payload."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter

    _check_schema(state, "restore_drafter")
    d = state.get("drafter", {})
    cfg = DrafterConfig(**d["cfg"]) if "cfg" in d else DrafterConfig()
    drafter = SuffixDrafter(cfg)
    return warm_drafter(drafter, state, build_trees=build_trees)


# -- filesystem ------------------------------------------------------------
def history_path(dir_or_file: str) -> str:
    if dir_or_file.endswith(".json"):
        return dir_or_file
    return os.path.join(dir_or_file, HISTORY_FILENAME)


def save_history(dir_or_file: str, state: Optional[Dict] = None, **kwargs) -> str:
    """Write a history payload to ``<dir>/history.json``.

    Pass either a prebuilt payload (``state=...``) or the
    ``history_state`` keyword arguments (store/drafter/length_policy/meta).
    """
    path = history_path(dir_or_file)
    if state is None:
        state = history_state(**kwargs)
    _check_schema(state, "save_history")
    return _atomic_write_json(path, state)


def load_history(dir_or_file: str) -> Dict[str, Any]:
    """Load ``<dir>/history.json``. Corrupt bytes (truncated / garbled
    JSON, or a document that is not a history payload) quarantine the
    file to ``history.json.corrupt`` and raise ``HistoryCorruptError``;
    a missing file raises ``FileNotFoundError`` as before."""
    return _load_checked_json(history_path(dir_or_file), kind="history")


# -- sharded service persistence -------------------------------------------
def shard_filename(shard_id: int) -> str:
    return f"history.shard{int(shard_id)}.json"


def save_service_history(
    dir_path: str,
    shard_states: Sequence[Dict[str, Any]],
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Persist a sharded history service: one crash-safe snapshot file
    per shard plus the manifest tying them together. The manifest is
    written LAST (also atomically), so a reader either sees a complete
    save or the previous one — never a half-written fleet."""
    entries: List[Dict[str, Any]] = []
    for i, state in enumerate(shard_states):
        _check_schema(state, f"save_service_history shard {i}")
        fn = shard_filename(state.get("shard_id", i))
        _atomic_write_json(os.path.join(dir_path, fn), state)
        entries.append({
            "file": fn,
            "shard_id": int(state.get("shard_id", i)),
            "n_rollouts": sum(
                int(d["n_appended"]) for _, d in state["store"]["problems"]
            ),
        })
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "kind": "history_manifest",
        "n_shards": len(entries),
        "shards": entries,
        "meta": dict(meta or {}),
    }
    return _atomic_write_json(
        os.path.join(dir_path, MANIFEST_FILENAME), manifest
    )


def load_service_history(dir_path: str) -> Dict[str, Any]:
    """Load a sharded history save: ``{"n_shards", "shards": [state...],
    "meta", "legacy", "quarantined": [path...]}``.

    Legacy path: a directory holding only a schema-1 single-store
    ``history.json`` (pre-manifest saves) loads as one shard — the
    service then owns the whole problem space under shard 0 of 1.

    Corruption never takes the fleet down: a corrupt / truncated /
    missing **shard file** is quarantined (renamed ``*.corrupt``) and
    its slot loads as ``None`` — ``reshard_states`` / the service
    cold-start that shard and it re-warms from the live rollout stream.
    A corrupt **manifest** quarantines and the whole save loads empty
    (shard files without a trustworthy manifest could belong to any
    geometry). Only a well-formed payload from an unknown FUTURE schema
    still raises ``HistorySchemaError`` — that is someone else's valid
    data, not corruption, and must not be destroyed or half-loaded.
    """
    quarantined: List[str] = []
    mpath = os.path.join(dir_path, MANIFEST_FILENAME)
    if not os.path.exists(mpath):
        legacy = load_history(dir_path)  # raises if absent/corrupt — loudly
        return {
            "n_shards": 1, "shards": [legacy],
            "meta": dict(legacy.get("meta", {})), "legacy": True,
            "quarantined": quarantined,
        }
    try:
        manifest = _load_checked_json(mpath, kind="manifest")
        if manifest.get("kind") != "history_manifest":
            _quarantine(mpath, f"kind={manifest.get('kind')!r}")
            raise HistoryCorruptError(f"{mpath}: not a history manifest")
    except HistoryCorruptError:
        # No trustworthy shard list -> empty (cold) fleet, loud log.
        quarantined.append(mpath + QUARANTINE_SUFFIX)
        return {
            "n_shards": 0, "shards": [], "meta": {}, "legacy": False,
            "quarantined": quarantined,
        }
    states: List[Optional[Dict[str, Any]]] = []
    for entry in manifest["shards"]:
        spath = os.path.join(dir_path, entry["file"])
        try:
            states.append(_load_checked_json(spath, kind="shard snapshot"))
        except FileNotFoundError:
            log.warning(
                "history shard file %s listed in manifest is missing; "
                "shard %s cold-starts", spath, entry.get("shard_id"),
            )
            states.append(None)
        except HistoryCorruptError:
            quarantined.append(spath + QUARANTINE_SUFFIX)
            states.append(None)
    return {
        "n_shards": int(manifest["n_shards"]),
        "shards": states,
        "meta": dict(manifest.get("meta", {})),
        "legacy": False,
        "quarantined": quarantined,
    }


def save_engine_history(
    engine, dir_or_file: str, meta: Optional[Dict[str, Any]] = None
) -> str:
    return save_history(dir_or_file, state=engine_state(engine, meta))


def load_engine_history(engine, dir_or_file: str, build_trees: bool = True):
    return restore_engine(engine, load_history(dir_or_file), build_trees)
