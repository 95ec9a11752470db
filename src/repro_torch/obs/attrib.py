"""Long-tail makespan attribution from flight-recorder data.

The paper's premise is that a handful of long rollouts dominate batch
makespan while the rest of the fleet idles. This module turns a flight
recording (events + spans, as captured by
:func:`repro_torch.obs.export.snapshot_dict` with ``flight>0``) into the
quantitative version of that claim:

* **stacked components per length class** — each rollout's wall time
  decomposed into ``queue_wait`` / ``prefill`` / ``verify`` /
  ``draft_host`` / ``accept_consume`` / ``stall_recovery``, plus the
  fleet-level ``idle_tail`` (workers finished, waiting on stragglers);
* **top-decile share** — fraction of makespan and of round-slots owed
  to the longest 10% of rollouts;
* **acceptance-vs-length** and **budget-vs-length** curves — whether
  the per-length-class budgets actually landed where the paper says
  they should (long rollouts get the deep budgets AND sustain the
  acceptance to use them).

CLI::

    python -m repro_torch.obs.attrib --snapshot run.jsonl        # full report
    python -m repro_torch.obs.attrib --journal-dir /ckpt/jrnl    # token/round
                                                           # distribution only
                                                           # (journals carry
                                                           # no timing)

Round wall time is attributed equally among the rollouts resident in
that round (they share the batch dimension of one forward pass), and
split across phase components in proportion to the tracer's span
totals for the same window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["attribute", "attribute_journals", "render_report", "main"]

COMPONENTS = (
    "queue_wait",
    "prefill",
    "verify",
    "draft_host",
    "accept_consume",
    "stall_recovery",
)

# span name -> phase component (everything else folds into verify's
# bucket only if it is round-loop work; unknown spans are ignored)
SPAN_PHASE = {
    "prefill": "prefill",
    "admission_coalesce": "prefill",
    "cache_commit": "prefill",
    "verify_forward": "verify",
    "verify_dispatch": "verify",
    "fused_dispatch": "verify",
    "budget_solve": "draft_host",
    "draft_dispatch": "draft_host",
    "forest_refresh": "draft_host",
    "history_sync": "draft_host",
    "history_publish": "draft_host",
    "consume": "accept_consume",
    "accept_emit": "accept_consume",
}

CLASS_NAMES = ("short", "medium", "long")


def _length_class(length: float, t_short: float, t_long: float) -> str:
    if length <= t_short:
        return "short"
    if length <= t_long:
        return "medium"
    return "long"


def _span_phase_fracs(spans: Sequence[dict]) -> Dict[str, float]:
    """Fraction of attributable span time per phase component.

    Only depth-minimal spans of each phase are counted (a nested
    ``cache_commit`` inside ``prefill`` must not double-bill)."""
    totals: Dict[str, float] = {}
    # per-name totals first; nested double counting is avoided by
    # billing child names only when the parent is NOT also mapped
    for s in spans:
        name = s.get("name")
        phase = SPAN_PHASE.get(name)
        if phase is None:
            continue
        parent = s.get("parent")
        if parent is not None and SPAN_PHASE.get(parent) == phase:
            continue  # parent already bills this window
        totals[phase] = totals.get(phase, 0.0) + float(s.get("dur_s", 0.0))
    tot = sum(totals.values())
    if tot <= 0:
        return {}
    return {k: v / tot for k, v in totals.items()}


def attribute(
    events: Sequence[dict],
    spans: Sequence[dict] = (),
    q_short: float = 0.5,
    q_long: float = 0.8,
) -> dict:
    """Decompose a flight recording into the long-tail report dict."""
    per: Dict[str, dict] = {}  # trace -> accumulators

    def _t(tr: str) -> dict:
        d = per.get(tr)
        if d is None:
            d = per[tr] = {
                "queued": None, "admit": None, "finish": None,
                "rounds": 0, "accepted": 0, "drafted": 0,
                "prefill_s": 0.0, "stall_s": 0.0,
                "pending_gap": None, "workers": set(),
                "budget_sum": 0, "emitted": 0,
            }
        return d

    # per-worker round timeline: consecutive "round" event timestamps
    # bound each round's wall window; residents share it equally
    worker_rounds: Dict[str, List[Tuple[float, List[str]]]] = {}
    makespan_t0: Optional[float] = None
    makespan_t1: Optional[float] = None

    for e in sorted(events, key=lambda e: (e.get("ts", 0.0), e.get("seq", 0))):
        tr = e.get("trace")
        kind = e.get("kind")
        ts = float(e.get("ts", 0.0))
        if makespan_t0 is None or ts < makespan_t0:
            makespan_t0 = ts
        if makespan_t1 is None or ts > makespan_t1:
            makespan_t1 = ts
        if tr is None:
            continue
        d = _t(tr)
        w = e.get("worker", "w?")
        if kind == "queued":
            d["queued"] = ts if d["queued"] is None else min(d["queued"], ts)
        elif kind in ("admit", "resume"):
            if d["admit"] is None:
                d["admit"] = ts
            d["workers"].add(w)
            d["prefill_s"] += float(e.get("dur") or 0.0)
            gap = d.pop("pending_gap", None)
            d["pending_gap"] = None
            if gap is not None:
                d["stall_s"] += max(ts - gap, 0.0)
        elif kind in ("preempt", "handoff", "stall"):
            d["pending_gap"] = ts
        elif kind == "round":
            d["rounds"] += 1
            d["accepted"] += int(e.get("accepted", 0))
            d["drafted"] += int(e.get("drafted", 0))
            d["budget_sum"] += int(e.get("drafted", 0))
            d["workers"].add(w)
            worker_rounds.setdefault(w, []).append((ts, [tr]))
        elif kind == "finish":
            d["finish"] = ts
            emitted = e.get("emitted")
            if emitted is not None:
                d["emitted"] = max(d["emitted"], int(emitted))

    # merge same-(worker, ts) round rows: one round event per resident
    # trace shares one wall window
    for w, rows in worker_rounds.items():
        rows.sort(key=lambda r: r[0])
        merged: List[Tuple[float, List[str]]] = []
        for ts, trs in rows:
            if merged and abs(ts - merged[-1][0]) < 1e-9:
                merged[-1][1].extend(trs)
            else:
                merged.append((ts, list(trs)))
        worker_rounds[w] = merged

    # per-trace round wall time: each round window split equally among
    # residents of that round
    round_wall: Dict[str, float] = {}
    for w, rows in worker_rounds.items():
        for (t_prev, _), (t_cur, residents) in zip(rows, rows[1:]):
            if not residents:
                continue
            share = max(t_cur - t_prev, 0.0) / len(residents)
            for tr in residents:
                round_wall[tr] = round_wall.get(tr, 0.0) + share
        # first round of each worker has no predecessor timestamp; use
        # the trace's admit time when available
        if rows:
            t0, residents = rows[0]
            for tr in residents:
                d = per.get(tr)
                if d and d["admit"] is not None:
                    round_wall[tr] = round_wall.get(tr, 0.0) + max(
                        t0 - d["admit"], 0.0
                    )

    phase_fracs = _span_phase_fracs(spans)
    # round wall splits across the three round-loop phases only
    loop_keys = ("verify", "draft_host", "accept_consume")
    loop_tot = sum(phase_fracs.get(k, 0.0) for k in loop_keys)
    if loop_tot > 0:
        loop_split = {k: phase_fracs.get(k, 0.0) / loop_tot for k in loop_keys}
    else:
        loop_split = {"verify": 1.0, "draft_host": 0.0, "accept_consume": 0.0}

    rollouts = []
    lengths: List[float] = []
    for tr, d in per.items():
        length = float(d["emitted"] or d["accepted"] or d["rounds"])
        lengths.append(length)
        comp = {
            "queue_wait": (
                max(d["admit"] - d["queued"], 0.0)
                if d["admit"] is not None and d["queued"] is not None else 0.0
            ),
            "prefill": d["prefill_s"],
            "stall_recovery": d["stall_s"],
        }
        rw = round_wall.get(tr, 0.0)
        for k in loop_keys:
            comp[k] = rw * loop_split[k]
        span = (
            max(d["finish"] - (d["queued"] if d["queued"] is not None
                               else d["admit"]), 0.0)
            if d["finish"] is not None
            and (d["queued"] is not None or d["admit"] is not None)
            else sum(comp.values())
        )
        rollouts.append({
            "trace": tr,
            "length": length,
            "rounds": d["rounds"],
            "accepted": d["accepted"],
            "drafted": d["drafted"],
            "wall_s": span,
            "components": comp,
            "workers": sorted(d["workers"]),
            "migrated": len(d["workers"]) > 1,
        })

    if not rollouts:
        return {"rollouts": [], "classes": {}, "makespan_s": 0.0,
                "top_decile": {}, "curves": {}, "n_rollouts": 0}

    # length-class thresholds from this run's realized distribution
    srt = sorted(lengths)

    def _q(q: float) -> float:
        i = min(int(q * (len(srt) - 1)), len(srt) - 1)
        return srt[i]

    t_short, t_long = _q(q_short), _q(q_long)
    for r in rollouts:
        r["class"] = _length_class(r["length"], t_short, t_long)

    makespan = (
        (makespan_t1 - makespan_t0)
        if makespan_t0 is not None and makespan_t1 is not None else 0.0
    )

    classes: Dict[str, dict] = {}
    for cname in CLASS_NAMES:
        rs = [r for r in rollouts if r["class"] == cname]
        agg = {k: sum(r["components"][k] for r in rs) for k in COMPONENTS}
        acc = sum(r["accepted"] for r in rs)
        dra = sum(r["drafted"] for r in rs)
        classes[cname] = {
            "n": len(rs),
            "components_s": agg,
            "wall_s": sum(r["wall_s"] for r in rs),
            "rounds": sum(r["rounds"] for r in rs),
            "accept_rate": (acc / dra) if dra else 0.0,
            "mean_budget": (dra / max(sum(r["rounds"] for r in rs), 1)),
            "mean_length": (
                sum(r["length"] for r in rs) / len(rs) if rs else 0.0
            ),
        }

    # attributed busy time vs fleet makespan -> idle tail
    n_workers = len(worker_rounds) or 1
    busy = sum(
        sum(r["components"][k] for k in
            ("prefill", "verify", "draft_host", "accept_consume"))
        for r in rollouts
    )
    idle_tail = max(makespan * n_workers - busy, 0.0)

    # top-decile-length rollouts' share of makespan and of round-slots
    by_len = sorted(rollouts, key=lambda r: r["length"], reverse=True)
    n_top = max(len(by_len) // 10, 1)
    top = by_len[:n_top]
    tot_wall = sum(r["wall_s"] for r in rollouts) or 1.0
    tot_rounds = sum(r["rounds"] for r in rollouts) or 1
    # critical-path share: the longest rollout's wall span over makespan
    # is the paper's "the tail IS the makespan" number
    longest_wall = max((r["wall_s"] for r in top), default=0.0)
    top_decile = {
        "n": n_top,
        "wall_share": sum(r["wall_s"] for r in top) / tot_wall,
        "round_share": sum(r["rounds"] for r in top) / tot_rounds,
        "makespan_share": (longest_wall / makespan) if makespan > 0 else 0.0,
        "min_length": top[-1]["length"],
    }

    # acceptance / budget vs length deciles
    accept_curve = []
    budget_curve = []
    n_bins = min(10, len(by_len))
    by_len_asc = by_len[::-1]
    for b in range(n_bins):
        lo = b * len(by_len_asc) // n_bins
        hi = (b + 1) * len(by_len_asc) // n_bins
        chunk = by_len_asc[lo:hi]
        if not chunk:
            continue
        acc = sum(r["accepted"] for r in chunk)
        dra = sum(r["drafted"] for r in chunk)
        rnd = sum(r["rounds"] for r in chunk)
        mlen = sum(r["length"] for r in chunk) / len(chunk)
        accept_curve.append({
            "mean_length": mlen, "accept_rate": (acc / dra) if dra else 0.0,
        })
        budget_curve.append({
            "mean_length": mlen, "mean_budget": dra / max(rnd, 1),
        })

    return {
        "n_rollouts": len(rollouts),
        "n_workers": n_workers,
        "makespan_s": makespan,
        "idle_tail_s": idle_tail,
        "thresholds": {"short": t_short, "long": t_long},
        "classes": classes,
        "top_decile": top_decile,
        "curves": {"acceptance": accept_curve, "budget": budget_curve},
        "migrated": sum(1 for r in rollouts if r["migrated"]),
        "rollouts": rollouts,
    }


def attribute_journals(journal_dir: str) -> dict:
    """Token/round distribution report from a directory of rollout
    journals. Journals carry no wall timing, so this reports the length
    distribution and round counts only — enough for the top-decile
    round-share number, not for wall components."""
    from repro_torch.fault.journal import RolloutJournal

    sessions = []
    for fn in sorted(os.listdir(journal_dir)):
        if not (fn.endswith(".wal") or fn.endswith(".journal")
                or fn.endswith(".jrnl")):
            continue
        path = os.path.join(journal_dir, fn)
        for key, sess in RolloutJournal.recover(path).items():
            sessions.append({
                "key": key,
                "trace": sess.trace,
                "tokens": len(sess.tokens),
                "rounds": sess.rounds,
                "finished": sess.finished,
                "journal": fn,
            })
    if not sessions:
        return {"n_rollouts": 0, "sessions": [], "top_decile": {}}
    by_len = sorted(sessions, key=lambda s: s["tokens"], reverse=True)
    n_top = max(len(by_len) // 10, 1)
    tot_rounds = sum(s["rounds"] for s in sessions) or 1
    tot_tokens = sum(s["tokens"] for s in sessions) or 1
    return {
        "n_rollouts": len(sessions),
        "n_finished": sum(1 for s in sessions if s["finished"]),
        "top_decile": {
            "n": n_top,
            "round_share": sum(s["rounds"] for s in by_len[:n_top])
            / tot_rounds,
            "token_share": sum(s["tokens"] for s in by_len[:n_top])
            / tot_tokens,
            "min_length": by_len[n_top - 1]["tokens"],
        },
        "sessions": sessions,
    }


def _fmt_s(v: float) -> str:
    return f"{v:8.3f}s"


def render_report(report: dict) -> str:
    """Human-readable rendering of :func:`attribute`'s dict."""
    out = []
    n = report.get("n_rollouts", 0)
    if not n:
        return "no rollouts in recording\n"
    if "classes" in report and report["classes"]:
        out.append(
            f"makespan attribution — {n} rollouts, "
            f"{report.get('n_workers', 1)} worker(s), "
            f"makespan {report.get('makespan_s', 0.0):.3f}s, "
            f"idle tail {report.get('idle_tail_s', 0.0):.3f}s"
        )
        th = report.get("thresholds", {})
        out.append(
            f"length classes: short ≤ {th.get('short', 0):.0f} < medium ≤ "
            f"{th.get('long', 0):.0f} < long (tokens)"
        )
        hdr = f"{'class':>8} {'n':>4} " + " ".join(
            f"{c:>14}" for c in COMPONENTS
        )
        out.append(hdr)
        for cname in CLASS_NAMES:
            c = report["classes"].get(cname)
            if c is None:
                continue
            row = f"{cname:>8} {c['n']:>4} " + " ".join(
                f"{_fmt_s(c['components_s'][k]):>14}" for k in COMPONENTS
            )
            out.append(row)
            out.append(
                f"{'':>13} accept_rate={c['accept_rate']:.3f} "
                f"mean_budget={c['mean_budget']:.2f} "
                f"mean_length={c['mean_length']:.1f}"
            )
    td = report.get("top_decile", {})
    if td:
        out.append(
            f"top decile by length (n={td.get('n')}, "
            f"length ≥ {td.get('min_length', 0):.0f}):"
        )
        if "wall_share" in td:
            out.append(
                f"  wall share {td['wall_share']:.1%} · round share "
                f"{td['round_share']:.1%} · longest rollout spans "
                f"{td['makespan_share']:.1%} of makespan"
            )
        else:
            out.append(
                f"  round share {td.get('round_share', 0):.1%} · token "
                f"share {td.get('token_share', 0):.1%}"
            )
    curves = report.get("curves", {})
    if curves.get("acceptance"):
        out.append("acceptance vs length (ascending deciles):")
        out.append("  " + " ".join(
            f"{p['accept_rate']:.2f}" for p in curves["acceptance"]
        ))
    if curves.get("budget"):
        out.append("realized budget vs length (ascending deciles):")
        out.append("  " + " ".join(
            f"{p['mean_budget']:.1f}" for p in curves["budget"]
        ))
    mig = report.get("migrated")
    if mig:
        out.append(f"{mig} rollout(s) migrated workers (handoff/resume)")
    return "\n".join(out) + "\n"


def _load_snapshot(path: str) -> Tuple[List[dict], List[dict]]:
    """Flight events + spans from a JSONL snapshot (one snapshot dict
    per line, as written by ``write_jsonl_snapshot``) or a single JSON
    document."""
    events: List[dict] = []
    spans: List[dict] = []
    with open(path) as f:
        text = f.read()
    docs: List[dict] = []
    try:
        one = json.loads(text)
        docs = one if isinstance(one, list) else [one]
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if line:
                docs.append(json.loads(line))
    for d in docs:
        events.extend(d.get("flight", ()))
        spans.extend(d.get("spans", ()))
    return events, spans


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.attrib",
        description="Long-tail makespan attribution from flight recordings",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--snapshot", help="JSONL/JSON telemetry snapshot "
                     "with flight events (see repro_torch.obs.export)")
    src.add_argument("--journal-dir", help="directory of rollout journals "
                     "(token/round distribution only — no wall timing)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report dict as JSON")
    ap.add_argument("--q-short", type=float, default=0.5)
    ap.add_argument("--q-long", type=float, default=0.8)
    args = ap.parse_args(argv)

    if args.snapshot:
        events, spans = _load_snapshot(args.snapshot)
        report = attribute(events, spans,
                           q_short=args.q_short, q_long=args.q_long)
    else:
        report = attribute_journals(args.journal_dir)

    if args.json:
        slim = {k: v for k, v in report.items()
                if k not in ("rollouts", "sessions")}
        json.dump(slim, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
