"""Render a run journal into terminal text or a markdown artifact.

Port of ``matcha_tpu/obs/report.py``: pure formatting, every number from
the journal.  ``summarize`` digests a journal; ``render_summary`` and
``render_summary_markdown`` draw it (``obs_torch.py summary [--md]``);
``render_tail`` prints the last events; ``compare_sources`` and
``render_compare`` put runs, bench records and link-cost artifacts in one
table (``obs_torch.py compare``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["summarize", "render_summary", "render_summary_markdown",
           "render_tail", "render_compare", "compare_sources"]

_SI = ((1e12, "TB"), (1e9, "GB"), (1e6, "MB"), (1e3, "kB"))


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    for scale, unit in _SI:
        if abs(n) >= scale:
            return f"{n / scale:.2f} {unit}"
    return f"{n:.0f} B"


from .journal import fmt_value as _fmt  # noqa: E402 — shared cell formatter


def summarize(events: List[dict]) -> Dict:
    """Digest a journal into the structure both renderers share."""
    from .journal import FAULT_KINDS, latest_per_epoch

    start = next((e for e in events if e.get("kind") == "run_start"), None)
    tel = latest_per_epoch(events, "telemetry")
    ep = latest_per_epoch(events, "epoch")
    epochs = sorted(set(tel) | set(ep))
    rows = []
    for e in epochs:
        t, p = tel.get(e, {}), ep.get(e, {})
        rows.append({
            "epoch": e,
            "loss": p.get("train_loss"),
            "acc": p.get("train_acc"),
            "disagreement": t.get("disagreement_mean", p.get("disagreement")),
            "wire_bytes": t.get("wire_bytes"),
            "matchings": t.get("matchings_mean"),
            "alive_min": t.get("alive_min"),
            "healed": t.get("healed"),
            "epoch_time": p.get("epoch_time"),
            "comm_time": p.get("comm_time"),
        })
    faults = [e for e in events if e.get("kind") in FAULT_KINDS]
    # same reader-side dedupe as telemetry/epoch: a crash-resume replays
    # its boundary reconciliation, journaling the transition again —
    # keep the latest per epoch, in epoch order
    membership = [e for _, e in
                  sorted(latest_per_epoch(events, "membership").items())]
    # heartbeat/anomaly replay the same way on resume: dedupe per
    # (epoch, host) and (epoch, subject, cause) keeping the latest — a
    # replayed epoch's fresh verdict supersedes, distinct findings survive
    heartbeats = [e for _, e in sorted(
        latest_per_epoch(events, "heartbeat",
                         key=lambda e: str(e.get("host"))).items(),
        key=lambda kv: kv[0])]
    anomalies = [e for _, e in sorted(
        latest_per_epoch(events, "anomaly",
                         key=lambda e: (str(e.get("subject")),
                                        str(e.get("cause")))).items(),
        key=lambda kv: kv[0])]
    drift = [e for e in events if e.get("kind") == "drift"]
    retrace = [e for e in events if e.get("kind") == "retrace"]
    bench = [e for e in events if e.get("kind") == "bench"]
    compiles = [e for e in events if e.get("kind") == "compile"]
    profiles = [e for e in events if e.get("kind") == "profile"]
    attributions = [e for e in events if e.get("kind") == "attribution"]
    total_bytes = sum(r["wire_bytes"] or 0.0 for r in rows) or None
    return {
        "start": start,
        "rows": rows,
        "faults": faults,
        "membership": membership,
        "heartbeat": heartbeats,
        "anomaly": anomalies,
        "drift": drift,
        "retrace": retrace,
        "bench": bench,
        "compile": compiles,
        "profile": profiles,
        "attribution": attributions,
        "total_wire_bytes": total_bytes,
        "events_total": len(events),
    }


def _header_lines(digest: Dict, source: str) -> List[str]:
    lines = [f"run journal: {source} ({digest['events_total']} events)"]
    start = digest["start"]
    if start:
        cfg = start.get("config", {})
        pred = start.get("predicted", {})
        lines.append(
            "  config: "
            + ", ".join(f"{k}={cfg[k]}" for k in
                        ("name", "model", "dataset", "num_workers", "budget",
                         "communicator", "overlap", "wire_dtype")
                        if k in cfg))
        if pred:
            lines.append(
                f"  plan: rho={_fmt(pred.get('rho'))} "
                f"(base {_fmt(pred.get('rho_base'))}), "
                f"steps/epoch={pred.get('steps_per_epoch', '-')}, "
                f"drift band=x{_fmt(1.0 + pred.get('tolerance', 0.25), 3)} "
                f"over {pred.get('patience', '-')} epochs")
    return lines


def render_summary(events: List[dict], source: str = "events.jsonl") -> str:
    digest = summarize(events)
    lines = _header_lines(digest, source)
    rows = digest["rows"]
    if rows:
        lines.append("")
        lines.append(f"{'epoch':>5} {'loss':>9} {'disagree':>10} "
                     f"{'wire':>10} {'match':>6} {'alive':>6} {'heal':>5} "
                     f"{'t[s]':>7} {'comm[s]':>8}")
        for r in rows:
            lines.append(
                f"{r['epoch']:>5} {_fmt(r['loss']):>9} "
                f"{_fmt(r['disagreement']):>10} "
                f"{_fmt_bytes(r['wire_bytes']):>10} "
                f"{_fmt(r['matchings'], 3):>6} {_fmt(r['alive_min'], 3):>6} "
                f"{_fmt(r['healed'], 3):>5} {_fmt(r['epoch_time'], 3):>7} "
                f"{_fmt(r['comm_time'], 3):>8}")
        lines.append(f"total wire bytes: "
                     f"{_fmt_bytes(digest['total_wire_bytes'])}")
    for e in digest["membership"]:
        lives = (int(sum(e.get("old_alive", []))),
                 int(sum(e.get("new_alive", []))))
        trig = ",".join(f"{t.get('kind')}:{t.get('worker')}"
                        for t in e.get("trigger", []))
        lines.append(
            f"membership @e{e.get('epoch')}: {lives[0]}→{lives[1]} live "
            f"[{trig}] alpha={_fmt(e.get('alpha'))} rho={_fmt(e.get('rho'))}"
            f"{'' if e.get('replanned') else ' (re-plan deferred)'}")
    if digest["heartbeat"]:
        hosts = sorted({str(e.get("host")) for e in digest["heartbeat"]})
        last = digest["heartbeat"][-1]
        lines.append(
            f"heartbeats: {len(digest['heartbeat'])} "
            f"(hosts: {', '.join(hosts)}; last @e{last.get('epoch')} "
            f"step {last.get('step')}, "
            f"ewma {_fmt(last.get('step_time_ewma'), 3)}s/step)")
    for e in digest["anomaly"]:
        lines.append(
            f"ANOMALY @e{e.get('epoch')}: {e.get('subject')} "
            f"{e.get('cause')} (value {_fmt(e.get('value'))} vs threshold "
            f"{_fmt(e.get('threshold'))})")
    for label, key in (("fault events", "faults"), ("drift events", "drift"),
                       ("retrace events", "retrace")):
        if digest[key]:
            lines.append(f"{label}: {len(digest[key])}")
            for e in digest[key]:
                detail = {k: v for k, v in e.items()
                          if k not in ("v", "t", "kind")}
                lines.append(f"  t={e.get('t', 0):.1f}s {e['kind']}: "
                             f"{json.dumps(detail, sort_keys=True)[:160]}")
    if digest["compile"]:
        lines.append(f"compiled programs (cost ledger): "
                     f"{len(digest['compile'])}")
        for e in digest["compile"]:
            lines.append(
                f"  {e.get('label', '?'):<14} {e.get('fingerprint', '')} "
                f"compile {_fmt(e.get('compile_seconds'), 3)}s  "
                f"flops {_fmt(e.get('flops'), 4)}  "
                f"hbm {_fmt_bytes(e.get('hbm_bytes'))}  "
                f"peak {_fmt_bytes(e.get('peak_bytes'))}")
    for e in digest["profile"]:
        frac = e.get("overlap_fraction")
        lines.append(f"profile: {os.path.basename(str(e.get('source')))} "
                     f"overlap {'-' if frac is None else f'{frac:.1%}'}")
    for e in digest["attribution"]:
        ident = e.get("identifiable") or []
        lines.append(
            f"attribution: {sum(bool(b) for b in ident)}/{len(ident)} "
            f"matchings identifiable over {e.get('epochs_used')} epochs "
            f"(base {_fmt(e.get('base_seconds'), 3)} s/epoch, "
            f"source {e.get('source')})")
    if digest["bench"]:
        lines.append(f"bench records: {len(digest['bench'])}")
    return "\n".join(lines)


def render_summary_markdown(events: List[dict],
                            source: str = "events.jsonl") -> str:
    digest = summarize(events)
    lines = [f"# Run journal — {os.path.basename(source)}", ""]
    for h in _header_lines(digest, source)[1:]:
        lines.append(f"- {h.strip()}")
    rows = digest["rows"]
    if rows:
        lines += ["",
                  "| epoch | loss | disagreement | wire | matchings "
                  "| alive_min | healed | epoch s | comm s |",
                  "|---:|---:|---:|---:|---:|---:|---:|---:|---:|"]
        for r in rows:
            lines.append(
                f"| {r['epoch']} | {_fmt(r['loss'])} "
                f"| {_fmt(r['disagreement'])} "
                f"| {_fmt_bytes(r['wire_bytes'])} | {_fmt(r['matchings'], 3)} "
                f"| {_fmt(r['alive_min'], 3)} | {_fmt(r['healed'], 3)} "
                f"| {_fmt(r['epoch_time'], 3)} | {_fmt(r['comm_time'], 3)} |")
        lines.append("")
        lines.append(f"Total wire bytes: "
                     f"**{_fmt_bytes(digest['total_wire_bytes'])}**")
    if digest["heartbeat"]:
        hosts = sorted({str(e.get("host")) for e in digest["heartbeat"]})
        lines += ["", f"Heartbeats: **{len(digest['heartbeat'])}** "
                      f"(hosts: {', '.join(hosts)})"]
    for label, key in (("Fault", "faults"), ("Membership", "membership"),
                       ("Anomaly", "anomaly"),
                       ("Drift", "drift"), ("Retrace", "retrace"),
                       ("Attribution", "attribution")):
        if digest[key]:
            lines += ["", f"## {label} events", ""]
            for e in digest[key]:
                detail = {k: v for k, v in e.items()
                          if k not in ("v", "t", "kind")}
                lines.append(f"- `t={e.get('t', 0):.1f}s` **{e['kind']}** "
                             f"`{json.dumps(detail, sort_keys=True)[:200]}`")
    if digest["compile"]:
        lines += ["", "## Compiled programs (cost ledger)", "",
                  "| label | fingerprint | compile s | FLOPs | HBM bytes "
                  "| peak |",
                  "|---|---|---:|---:|---:|---:|"]
        for e in digest["compile"]:
            lines.append(
                f"| {e.get('label')} | `{e.get('fingerprint')}` "
                f"| {_fmt(e.get('compile_seconds'), 3)} "
                f"| {_fmt(e.get('flops'), 4)} "
                f"| {_fmt_bytes(e.get('hbm_bytes'))} "
                f"| {_fmt_bytes(e.get('peak_bytes'))} |")
    lines.append("")
    return "\n".join(lines)


def render_tail(events: List[dict], n: int = 20) -> str:
    lines = []
    for e in events[-n:]:
        detail = {k: v for k, v in e.items() if k not in ("v", "t", "kind")}
        lines.append(f"t={e.get('t', 0):>8.1f}s  {e.get('kind', '?'):<22} "
                     f"{json.dumps(detail, sort_keys=True)[:140]}")
    return "\n".join(lines) if lines else "(empty journal)"


def _bench_row(label: str, record: Dict) -> Dict:
    return {
        "source": label,
        "value": record.get("value"),
        "unit": record.get("unit"),
        "backend": record.get("backend"),
        "vs_baseline": record.get("vs_baseline"),
        "device_kind": record.get("device_kind"),
        "mfu": record.get("mfu"),
    }


def compare_sources(sources: Sequence[str]) -> Tuple[List[Dict], List[str]]:
    """Rows for ``obs_torch.py compare`` from heterogeneous sources.

    Accepts run dirs / journal files (``bench`` events and the last
    telemetry flush become rows), bare ``BENCH_r*.json`` records (the
    pre-journal capture format), ``MULTICHIP_r*.json`` stamps and
    ``measured_link_costs.json`` artifacts, in one table.  Returns
    ``(rows, problems)``; unreadable sources are reported, not fatal.
    """
    from .journal import read_journal, resolve_journal_path

    rows: List[Dict] = []
    problems: List[str] = []
    for src in sources:
        label = os.path.basename(src.rstrip("/")) or src
        try:
            if src.endswith(".json"):
                with open(src) as f:
                    rec = json.load(f)
                # measured_link_costs.json, the attribution plane's
                # artifact: the comparable number is the total
                # identifiable matching seconds, so two runs' measured
                # link economies land side by side
                if str(rec.get("format", "")).startswith(
                        "matcha_tpu.link_costs"):
                    per = rec.get("per_matching", [])
                    ident = [r for r in per if r.get("identifiable")]
                    rows.append({
                        "source": label,
                        "value": (sum(float(r["seconds"]) for r in ident)
                                  if ident else None),
                        "unit": "matching_seconds_total",
                        "backend": f"{len(ident)}/{len(per)} identifiable",
                        "vs_baseline": None,
                        "device_kind": None,
                        "mfu": None,
                    })
                    continue
                # MULTICHIP_r*.json, a multi-device dry-run stamp:
                # n_devices is the comparable number, ok/rc the verdict
                if "n_devices" in rec and "ok" in rec:
                    rows.append({
                        "source": label,
                        "value": float(rec.get("n_devices") or 0),
                        "unit": "multichip_dryrun_devices",
                        "backend": ("skipped" if rec.get("skipped")
                                    else "ok" if rec.get("ok")
                                    else f"rc={rec.get('rc')}"),
                        "vs_baseline": None,
                        "device_kind": None,
                        "mfu": None,
                    })
                    continue
                # unwrap the known capture formats: bench_live_r*.json
                # ({"record": ...}) and a BENCH_r*.json capture's
                # ({"parsed": ...} with the raw line in "tail")
                rec = rec.get("record", rec)
                rec = rec.get("parsed") or rec
                if "value" not in rec and isinstance(rec.get("tail"), str):
                    try:
                        rec = json.loads(rec["tail"].strip().splitlines()[-1])
                    except (json.JSONDecodeError, IndexError):
                        pass
                rows.append(_bench_row(label, rec))
                continue
            events = read_journal(resolve_journal_path(src))
            bench = [e for e in events if e.get("kind") == "bench"]
            if bench:
                for i, e in enumerate(bench):
                    tag = e.get("round", i + 1)
                    rows.append(_bench_row(f"{label}#{tag}",
                                           e.get("record", {})))
            else:
                digest = summarize(events)
                last = digest["rows"][-1] if digest["rows"] else {}
                rows.append({
                    "source": label,
                    "value": last.get("disagreement"),
                    "unit": "disagreement_rms",
                    "backend": (digest["start"] or {}).get(
                        "config", {}).get("communicator"),
                    "vs_baseline": None,
                    "device_kind": None,
                    "mfu": None,
                    "wire_bytes": digest["total_wire_bytes"],
                    # the health verdict travels with the run: a number
                    # from an anomalous fleet is not comparable evidence
                    "anomalies": (len(digest["anomaly"])
                                  if digest["heartbeat"]
                                  or digest["anomaly"] else None),
                })
        except (OSError, ValueError, KeyError) as e:
            problems.append(f"{src}: {type(e).__name__}: {e}")
    # completeness: whenever any BENCH_r*.json is compared, every sibling
    # BENCH_r*.json in its directory lands in the table too, or the
    # omission is named in the rendered output
    import glob as _glob
    import re as _re

    bench_dirs = sorted({
        os.path.dirname(os.path.abspath(s)) for s in sources
        if _re.fullmatch(r"BENCH_r\d+\.json", os.path.basename(s))})
    given = {os.path.abspath(s) for s in sources}
    for d in bench_dirs:
        for sib in sorted(_glob.glob(os.path.join(d, "BENCH_r*.json"))):
            if os.path.abspath(sib) not in given:
                problems.append(
                    f"missing from table: {os.path.basename(sib)} (sits "
                    f"next to a compared BENCH record in {d})")
    return rows, problems


def render_compare(rows: List[Dict], problems: List[str],
                   markdown: bool = False) -> str:
    cols = ("source", "value", "unit", "backend", "vs_baseline",
            "device_kind", "mfu", "anomalies")
    if markdown:
        lines = ["| " + " | ".join(cols) + " |",
                 "|" + "|".join("---" for _ in cols) + "|"]
        for r in rows:
            lines.append("| " + " | ".join(_fmt(r.get(c)) for c in cols)
                         + " |")
    else:
        widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows))
                  if rows else len(c) for c in cols}
        lines = [" ".join(c.ljust(widths[c]) for c in cols)]
        for r in rows:
            lines.append(" ".join(_fmt(r.get(c)).ljust(widths[c])
                                  for c in cols))
    for p in problems:
        # completeness misses carry their own verb; read failures keep
        # the historical "unreadable" tag
        prefix = "# " if p.startswith("missing from table:") \
            else "# unreadable: "
        lines.append(prefix + p)
    return "\n".join(lines)
