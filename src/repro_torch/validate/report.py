"""Machine-readable conformance reports (JSON), consumed by CI and
``experiments/make_report.py``.

The port's own copy of ``repro.validate.report``: the schema is the same,
so a report written by either package loads in the other and renders the
same summary line.

Schema (one file per suite run):

    {
      "meta":    {"suite": "...", "seed": ..., "trials": ..., ...},
      "results": [{"check": ..., "sampler": ..., "scheme": ..., "p": ...,
                   "path": ..., "status": "pass"|"fail"|"skip",
                   "details": {...}}, ...],
      "summary": {"passed": N, "failed": N, "skipped": N, "total": N}
    }

``summary_line`` renders the one-line machine-greppable summary that the
CI bench-smoke job asserts on (``conformance_summary,...``).
"""
from __future__ import annotations

import json
from typing import Iterable, NamedTuple, Optional

PASS = "pass"
FAIL = "fail"
SKIP = "skip"


class CheckResult(NamedTuple):
    """One named check against one (sampler, scheme, p, path) cell."""

    check: str
    sampler: str
    scheme: str
    p: float
    path: str
    status: str          # pass | fail | skip
    details: dict        # measured statistics + derived tolerances

    @property
    def passed(self) -> bool:
        return self.status != FAIL

    def to_dict(self) -> dict:
        return {"check": self.check, "sampler": self.sampler,
                "scheme": self.scheme, "p": self.p, "path": self.path,
                "status": self.status, "details": _jsonable(self.details)}


def _jsonable(x):
    """Coerce numpy/torch scalars and arrays into JSON-serializable values."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def build(results: Iterable[CheckResult], meta: Optional[dict] = None
          ) -> dict:
    results = list(results)
    summary = {
        "passed": sum(r.status == PASS for r in results),
        "failed": sum(r.status == FAIL for r in results),
        "skipped": sum(r.status == SKIP for r in results),
        "total": len(results),
    }
    return {"meta": _jsonable(meta or {}),
            "results": [r.to_dict() for r in results],
            "summary": summary}


def write(report: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    return path


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def ok(report: dict) -> bool:
    return report["summary"]["failed"] == 0


def summary_line(report: dict) -> str:
    """The greppable one-liner: conformance_summary,passed=..,failed=..,
    skipped=..,total=.. (CI bench-smoke asserts its presence + failed=0)."""
    s = report["summary"]
    return (f"conformance_summary,passed={s['passed']},failed={s['failed']},"
            f"skipped={s['skipped']},total={s['total']}")


def failures(report: dict) -> list:
    return [r for r in report["results"] if r["status"] == FAIL]


def format_markdown(report: dict) -> str:
    """Render the report as a markdown table (experiments/make_report.py)."""
    out = ["| check | sampler | scheme | p | path | status | worst margin |",
           "|---|---|---|---:|---|---|---:|"]
    for r in report["results"]:
        margin = r["details"].get("worst_margin", "")
        if isinstance(margin, float):
            margin = f"{margin:.3g}"
        out.append(f"| {r['check']} | {r['sampler']} | {r['scheme']} "
                   f"| {r['p']:g} | {r['path']} | {r['status']} | {margin} |")
    s = report["summary"]
    out.append("")
    out.append(f"**{s['passed']} pass / {s['failed']} fail / "
               f"{s['skipped']} skip** (of {s['total']})")
    return "\n".join(out)
