"""The OpenMetrics / Prometheus text-exposition parser (copy of
timetabling_ga_tpu/obs/scrape.py, under the same names).

One parser for every consumer of a `/metrics` scrape (obs/http.py's
pull front): `parse_exposition` maps a scrape to its samples by wire
name, `parse_exemplars` lists the histogram buckets' exemplars, and
`scalar`, `labeled` and `hit_rate` read one family. It handles both
expositions the registry (obs/metrics.py) renders: the Prometheus 0.0.4
text format and OpenMetrics 1.0 with exemplars
(`name{le="0.5"} 3 # {job="j42"} 0.93`) and the `# EOF` trailer.
Unparseable lines are skipped, never fatal: a scrape degrades, it does
not raise.

The family names the fleet's router and prober score on (QUEUE_DEPTH,
BACKLOG, COMPILE_COUNT, COMPILE_HITS, FLIGHT_DUMPS, RESIDENT_GROUPS,
RESIDENT_BYTES) are kept beside the parser as in the JAX package.
Stdlib only.
"""

from __future__ import annotations

import re

# the metric families the fleet router scores on (fleet/router.py):
# kept here, next to the parser, so the prober and any future scrape
# consumer name them identically
QUEUE_DEPTH = "tt_serve_queue_depth"
BACKLOG = "tt_serve_backlog"
COMPILE_COUNT = "tt_compile_count_total"
COMPILE_HITS = "tt_compile_cache_hits_total"
# tt-flight: the replica's incident-dump counter (obs/flight.py). The
# prober watches it across probes and fetches GET /v1/incident when it
# advances, so the gateway holds a replica's newest bundle even after
# the replica dies — the "30 seconds before the failover" evidence
FLIGHT_DUMPS = "tt_flight_dumps_total"
# device residency (serve/scheduler.py RESIDENCY): groups parked on
# device between quanta and the bytes a retire would flush. The
# autoscaler's residency-aware victim choice scores on both
# (fleet/autoscaler.py choose_victim) — retiring a cold replica costs
# nothing; retiring a warm one flushes every resident group
RESIDENT_GROUPS = "tt_serve_resident_groups"
RESIDENT_BYTES = "tt_serve_resident_bytes"

# one sample line: name, optional {labels}, value, optional exemplar
# (OpenMetrics: " # {labels} value [timestamp]")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s#]+)"
    r"(?:\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+).*)?"
    r"\s*$")

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    """Label-value unescaping (the inverse of obs/metrics.py
    `_escape_label`): backslash, double quote, newline."""
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_labels(block: str) -> dict:
    """`le="0.5",job="j 42"` -> {"le": "0.5", "job": "j 42"}."""
    return {m.group(1): _unescape(m.group(2))
            for m in _LABEL_RE.finditer(block or "")}


def parse_exposition(text: str) -> dict:
    """Exposition text -> {sample_name: [(labels_dict, value), ...]}.

    Sample names are the WIRE names (`tt_serve_queue_depth`,
    `tt_compile_count_total`, `tt_fleet_job_seconds_bucket`) — one
    entry per sample line, in document order. Comment lines (`# TYPE`,
    `# HELP`, `# EOF`) and anything unparseable are skipped."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append(
            (parse_labels(m.group("labels")), value))
    return out


def parse_exemplars(text: str) -> list:
    """OpenMetrics bucket exemplars: [(sample_name, labels_dict,
    value), ...] in document order — the (job/dispatch, latency)
    pairs a p99 spike joins back to. Same regex as parse_exposition,
    so there is exactly one copy of the format knowledge."""
    out = []
    for line in text.splitlines():
        m = _SAMPLE_RE.match(line.strip())
        if m is None or m.group("exvalue") is None:
            continue
        try:
            v = float(m.group("exvalue"))
        except ValueError:
            continue
        out.append((m.group("name"),
                    parse_labels(m.group("exlabels")), v))
    return out


def scalar(families: dict, name: str, default=None):
    """First unlabeled (or only) sample of `name`, or `default` — the
    gauge/counter read every router input is."""
    samples = families.get(name)
    if not samples:
        return default
    for labels, value in samples:
        if not labels:
            return value
    return samples[0][1]


def labeled(families: dict, name: str, **want):
    """First sample of `name` whose labels include all of `want`
    (e.g. `labeled(fams, "tt_fleet_job_seconds_bucket", le="+Inf")`),
    or None."""
    for labels, value in families.get(name, ()):
        if all(labels.get(k) == v for k, v in want.items()):
            return value
    return None


def hit_rate(families: dict) -> float:
    """Measured compile-hit rate from the families the router scrapes
    (obs/cost.py accounting): hits / (count + hits), 0.0 when the
    process has never compiled."""
    count = scalar(families, COMPILE_COUNT, 0.0) or 0.0
    hits = scalar(families, COMPILE_HITS, 0.0) or 0.0
    total = count + hits
    return hits / total if total > 0 else 0.0
