"""SARIF 2.1.0 export for the port's tt-analyze findings (stdlib-only;
the counterpart of timetabling_ga_tpu/analysis/sarif.py, whose output it
matches but for the tool's name).

`python -m timetabling_ga_tpu_torch.analysis --sarif` emits one run in
the Static Analysis Results Interchange Format so CI hosts render
findings as inline annotations.
Only the core subset is produced — tool.driver.rules, results with one
physical location each — which is exactly what the annotation UIs
consume. Columns are 1-based in SARIF; `Finding.col` carries the
0-based AST offset, hence the +1.
"""

from __future__ import annotations

_SCHEMA = ("https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/"
           "os/schemas/sarif-schema-2.1.0.json")

TOOL = "tt-analyze-torch"


def to_sarif(findings, rule_docs: dict[str, str], tool: str = TOOL) -> dict:
    """A SARIF 2.1.0 log dict for `findings`; `rule_docs` maps rule id
    -> one-line description for the tool.driver.rules table."""
    rule_ids = sorted({f.rule for f in findings})
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool,
                "rules": [{
                    "id": rid,
                    "shortDescription": {
                        "text": rule_docs.get(rid, rid)},
                } for rid in rule_ids],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error" if f.rule == "TT000" else "warning",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace("\\", "/")},
                        "region": {"startLine": f.line,
                                   "startColumn": f.col + 1},
                    },
                }],
            } for f in findings],
        }],
    }
