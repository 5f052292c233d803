"""The fleet autoscaler's decision report (copy of timetabling_ga_tpu/
fleet/autoscaler.py:507-585, `summarize_entries` and `_evidence_lines`):
the scaleEntry section of the `stats` subcommand. The autoscaler itself
is not ported yet; this module holds only its report. Stdlib only.
"""

from __future__ import annotations


def summarize_entries(records) -> str:
    """The `tt scale` / `tt stats == scale` report over scaleEntry
    records: the decision log with its sustained-window evidence,
    plus action/block tallies."""
    entries = [r["scaleEntry"] for r in records if "scaleEntry" in r]
    if not entries:
        return "== scale: no scaleEntry records"
    lines = [f"== scale decisions ({len(entries)} records)"]
    tallies: dict = {}
    for e in entries:
        kind = (f"blocked_{e['blocked']}" if e.get("blocked")
                else e.get("action", "?"))
        tallies[kind] = tallies.get(kind, 0) + 1
        ts = e.get("ts")
        head = f"  {ts:.1f}s" if isinstance(ts, (int, float)) else "  -"
        what = (f"{e.get('action')} ({e.get('reason')})"
                + (f" BLOCKED:{e['blocked']}" if e.get("blocked")
                   else ""))
        parts = [head, what]
        if e.get("replica"):
            sign = "-" if e.get("action") == "down" else "+"
            parts.append(f"{sign}{e['replica']}")
        if e.get("live") is not None:
            tgt = (f"->{e['target']}" if e.get("target") is not None
                   else "")
            parts.append(f"live {e['live']}{tgt}")
        if e.get("dry_run"):
            parts.append("[dry-run]")
        lines.append(" ".join(parts))
        for line in _evidence_lines(e.get("evidence") or {}):
            lines.append("      " + line)
    lines.append("  " + "  ".join(f"{k}:{v}"
                                  for k, v in sorted(tallies.items())))
    return "\n".join(lines)


def _evidence_lines(ev: dict) -> list:
    """Render one decision's evidence dict: the window queries that
    justified it, one per line."""
    out = []
    for name, v in sorted(ev.items()):
        if name == "demand_flops_per_s" and isinstance(v, dict):
            flat = " ".join(f"{t}:{r:g}" for t, r in sorted(v.items()))
            out.append(f"demand flop/s: {flat}")
        elif name == "replicas" and isinstance(v, dict):
            def _res(d):
                rg = d.get("resident_groups")
                if rg is None:
                    return ""
                if rg == 0:
                    return ", cold"
                rb = d.get("resident_bytes")
                return (f", {rg:g} resident"
                        + (f" ({rb:g}B)" if rb is not None else ""))
            flat = " ".join(
                f"{n}(inflight {d.get('inflight', 0)}, "
                f"mean backlog "
                f"{d.get('backlog_mean') if d.get('backlog_mean') is not None else '?'}"
                f"{', idle' if d.get('idle') else ''}{_res(d)})"
                for n, d in sorted(v.items()))
            out.append(f"victims considered: {flat}")
        elif name == "warmth_skipped" and isinstance(v, dict):
            flat = "; ".join(f"{n} sole-warm for {b}"
                             for n, b in sorted(v.items()))
            out.append(f"warmth guard: {flat}")
        elif isinstance(v, dict) and "op" in v:
            mean = (f", window mean {v['mean']:g}"
                    if isinstance(v.get("mean"), (int, float))
                    else "")
            out.append(f"{name} {v['op']} {v['threshold']:g} "
                       f"sustained {v['for_s']:g}s{mean}")
        elif isinstance(v, dict) and "rate_per_s" in v:
            out.append(f"{name} rate {v['rate_per_s']:g}/s >= "
                       f"{v['threshold']:g} over {v['window_s']:g}s")
        else:
            out.append(f"{name}: {v}")
    return out
