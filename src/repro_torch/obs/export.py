"""Exporters over the metrics registry: JSONL, Prometheus text, CLI check
(the port's ``repro.obs.export``, whole).

JSONL is the machine-readable snapshot CI archives (one JSON object per
series line); the Prometheus text format is for scraping a long-lived
process.  Both are pure views over :meth:`Registry.snapshot` — no state
of their own — so an export taken at any moment is internally consistent
per series.

The module doubles as a CLI::

    python -m repro_torch.obs.export --check telemetry.jsonl \
        --require tune.cache.hit --require ladder.served

exits non-zero listing any required series absent from the file.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import metrics

__all__ = [
    "to_jsonl",
    "to_prometheus",
    "read_jsonl",
    "jsonl_series_names",
    "missing_series",
]

_HIST_FIELDS = ("count", "sum", "mean", "max", "p50", "p95", "p99")


def _rows(registry: Optional[metrics.Registry] = None) -> List[Dict]:
    reg = registry if registry is not None else metrics.registry()
    rows: List[Dict] = []
    for m in reg.metrics():
        for r in m.export_rows():
            row = {"series": m.name, "type": m.kind, "labels": r["labels"]}
            if m.kind == "histogram":
                for f in _HIST_FIELDS:
                    row[f] = r[f]
            else:
                row["value"] = r["value"]
            rows.append(row)
    return rows


def to_jsonl(path: str, registry: Optional[metrics.Registry] = None) -> int:
    """Write one JSON object per series to ``path``; returns line count."""
    rows = _rows(registry)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return len(rows)


def read_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def jsonl_series_names(path: str) -> List[str]:
    return sorted({r["series"] for r in read_jsonl(path)})


def missing_series(path: str, required: Iterable[str]) -> List[str]:
    """Required series names absent from a JSONL export — [] when all present."""
    have = set(jsonl_series_names(path))
    return [n for n in required if n not in have]


def _prom_name(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (_prom_name(str(k)), str(v).replace('"', '\\"'))
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def to_prometheus(registry: Optional[metrics.Registry] = None) -> str:
    """Prometheus exposition text.  Histograms export as <name>_count /
    <name>_sum plus quantile gauges (summary-style, reservoir-estimated)."""
    reg = registry if registry is not None else metrics.registry()
    lines: List[str] = []
    for m in reg.metrics():
        pname = _prom_name(m.name)
        if m.kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for r in m.export_rows():
                lbl = r["labels"]
                for q, field in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                    qlbl = dict(lbl, quantile=q)
                    lines.append(f"{pname}{_prom_labels(qlbl)} {r[field]}")
                lines.append(f"{pname}_sum{_prom_labels(lbl)} {r['sum']}")
                lines.append(f"{pname}_count{_prom_labels(lbl)} {r['count']}")
        else:
            lines.append(f"# TYPE {pname} {m.kind}")
            for r in m.export_rows():
                lines.append(f"{pname}{_prom_labels(r['labels'])} {r['value']}")
    return "\n".join(lines) + ("\n" if lines else "")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Check or dump a repro_torch.obs JSONL telemetry export."
    )
    p.add_argument("--check", metavar="PATH", help="JSONL export to check")
    p.add_argument(
        "--require",
        action="append",
        default=[],
        metavar="SERIES",
        help="series name that must be present (repeatable)",
    )
    p.add_argument(
        "--list", action="store_true", help="print the series names found"
    )
    args = p.parse_args(argv)
    if not args.check:
        p.error("--check PATH is required")
    names = jsonl_series_names(args.check)
    if args.list:
        for n in names:
            print(n)
    missing = [n for n in args.require if n not in set(names)]
    if missing:
        print(
            f"MISSING required series in {args.check}: {', '.join(missing)}",
            file=sys.stderr,
        )
        return 1
    if args.require:
        print(f"all {len(args.require)} required series present in {args.check}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
