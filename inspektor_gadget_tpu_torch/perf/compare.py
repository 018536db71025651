"""Noise-aware regression comparison + report rendering over the ledger
(the port's copy of ``inspektor_gadget_tpu/perf/compare.py``).

Baseline policy:

- a candidate is only compared against ledger records with the SAME
  config, metric, and platform;
- `degraded: true` records are NEVER baseline material;
- an accelerator candidate (``gpu``, or the reference's ``tpu``) whose
  only same-config history is degraded or on another platform is
  REFUSED (exit code 3) rather than silently compared: a claim made on
  the card must not inherit a CPU baseline, in either direction. The
  reference refuses a ``tpu`` candidate only; for a ``gpu`` candidate it
  reports no baseline.

The band is noise-aware: tolerance = max(band_frac · median,
NOISE_SIGMAS · stdev of the baseline pool), so a config whose history is
jittery doesn't cry wolf while a stable one still trips on small slips.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

from ..columns import Columns, col
from ..columns.formatter import TextFormatter

DEFAULT_K = 5
DEFAULT_BAND = 0.15
NOISE_SIGMAS = 3.0

# exit codes for `ig-tpu-torch bench compare`
RC_OK = 0
RC_REGRESSION = 1
RC_USAGE = 2
RC_REFUSED = 3

# platforms whose claims never baseline against another platform's records
ACCELERATORS = {"tpu": "TPU", "gpu": "GPU"}


@dataclasses.dataclass
class CompareResult:
    config: str
    status: str            # ok | improved | regression | no-baseline | refused
    value: float
    baseline: float = 0.0
    low: float = 0.0
    high: float = 0.0
    ratio: float = 0.0     # value / baseline (1.0 == at baseline)
    pool_n: int = 0
    detail: str = ""

    @property
    def rc(self) -> int:
        if self.status == "regression":
            return RC_REGRESSION
        if self.status == "refused":
            return RC_REFUSED
        return RC_OK


def _same_series(rec: dict, cand: dict) -> bool:
    return (rec.get("config") == cand.get("config")
            and rec.get("metric") == cand.get("metric"))


def baseline_pool(history: list[dict], candidate: dict,
                  k: int = DEFAULT_K) -> list[dict]:
    """Last k same-config/metric/platform, NON-degraded records, excluding
    the candidate itself if it already sits in the ledger."""
    plat = candidate.get("provenance", {}).get("platform")
    # self-exclusion is by identity/content, NOT timestamp: ts has
    # 1-second resolution and two fast runs can legitimately share one
    pool = [r for r in history
            if _same_series(r, candidate)
            and r is not candidate and r != candidate
            and r.get("provenance", {}).get("platform") == plat
            and not r.get("provenance", {}).get("degraded")]
    return pool[-k:]


def compare_record(candidate: dict, history: list[dict],
                   k: int = DEFAULT_K,
                   band: float = DEFAULT_BAND) -> CompareResult:
    config = str(candidate.get("config", "?"))
    value = float(candidate.get("value", 0.0))
    prov = candidate.get("provenance", {})
    plat = prov.get("platform")
    pool = baseline_pool(history, candidate, k)
    if not pool:
        same_cfg = [r for r in history if _same_series(r, candidate)
                    and r is not candidate and r != candidate]
        if plat in ACCELERATORS and same_cfg:
            # history exists but none of it is baseline-grade for a claim
            # made on the accelerator: refuse loudly instead of comparing
            why = sorted({
                "degraded" if r.get("provenance", {}).get("degraded")
                else f"platform={r.get('provenance', {}).get('platform')}"
                for r in same_cfg})
            return CompareResult(
                config=config, status="refused", value=value,
                pool_n=0,
                detail=(f"refusing to baseline a {ACCELERATORS[plat]} claim: all "
                        f"{len(same_cfg)} same-config records are "
                        f"{'/'.join(why)}"))
        return CompareResult(config=config, status="no-baseline",
                             value=value, pool_n=0,
                             detail="no eligible baseline records yet")
    values = [float(r["value"]) for r in pool]
    med = statistics.median(values)
    sigma = statistics.stdev(values) if len(values) >= 2 else 0.0
    tol = max(band * abs(med), NOISE_SIGMAS * sigma)
    low, high = med - tol, med + tol
    direction = candidate.get("direction", "higher_better")
    if direction == "higher_better":
        regressed, improved = value < low, value > high
    else:
        regressed, improved = value > high, value < low
    status = ("regression" if regressed
              else "improved" if improved else "ok")
    return CompareResult(
        config=config, status=status, value=value, baseline=med,
        low=low, high=high,
        ratio=value / med if med else 0.0, pool_n=len(pool),
        detail=(f"baseline median {med:.4g} over {len(pool)} records, "
                f"band [{low:.4g}, {high:.4g}], σ={sigma:.3g}"))


def latest_per_config(records: list[dict]) -> list[dict]:
    """Last record of each (config, metric) series, in ledger order."""
    seen: dict[tuple, dict] = {}
    for r in records:
        seen[(r.get("config"), r.get("metric"))] = r
    return list(seen.values())


def compare_ledger(records: list[dict], configs: list[str] | None = None,
                   k: int = DEFAULT_K,
                   band: float = DEFAULT_BAND) -> list[CompareResult]:
    """Treat the newest record of each series as the candidate and the
    rest as history."""
    out = []
    for cand in latest_per_config(records):
        if configs and cand.get("config") not in configs:
            continue
        history = [r for r in records if r is not cand]
        out.append(compare_record(cand, history, k=k, band=band))
    return out


# -- report rendering, through the column system like every other surface ------

@dataclasses.dataclass
class PerfReportRow:
    ts: str = col("", width=20)
    config: str = col("", width=16)
    platform: str = col("", width=8)
    degraded: bool = col(False, width=8)
    value: float = col(0.0, width=14, precision=1, align="right",
                       dtype=np.float64)
    unit: str = col("", width=16)
    vs_prev: str = col("", width=8, align="right")
    git: str = col("", width=10)
    stage_hot: str = col("", width=24, description="slowest stage this run")


def _hot_stage(rec: dict) -> str:
    stages = rec.get("stages") or {}
    worst = ""
    worst_s = 0.0
    for name, st in stages.items():
        s = float(st.get("seconds", 0.0))
        if s > worst_s:
            worst, worst_s = name, s
    # imported artifacts carry no stage timings: show nothing rather than
    # a fake 0.000s
    return f"{worst} {worst_s:.3f}s" if worst else ""


def report_rows(records: list[dict], last: int = 10,
                configs: list[str] | None = None) -> list[PerfReportRow]:
    rows = []
    prev_by_series: dict[tuple, float] = {}
    for rec in records:
        if configs and rec.get("config") not in configs:
            continue
        prov = rec.get("provenance", {})
        # vs_prev compares within (config, metric, platform): a CPU run
        # must not read as a -97% regression of a series on the card
        key = (rec.get("config"), rec.get("metric"),
               prov.get("platform"), bool(prov.get("degraded")))
        prev = prev_by_series.get(key)
        vs = f"{(rec['value'] - prev) / prev:+.1%}" if prev else ""
        prev_by_series[key] = float(rec["value"])
        rows.append(PerfReportRow(
            ts=str(rec.get("ts", ""))[:19],
            config=str(rec.get("config", "")),
            platform=str(prov.get("platform", "?")),
            degraded=bool(prov.get("degraded")),
            value=float(rec.get("value", 0.0)),
            unit=str(rec.get("unit", "")),
            vs_prev=vs,
            git=str(prov.get("git_sha", ""))[:8]
            + ("*" if prov.get("git_dirty") else ""),
            stage_hot=_hot_stage(rec),
        ))
    return rows[-last:] if last else rows


def render_report(records: list[dict], last: int = 10,
                  configs: list[str] | None = None) -> str:
    rows = report_rows(records, last=last, configs=configs)
    cols = Columns(PerfReportRow)
    fmt = TextFormatter(cols)
    if not rows:
        return "(perf ledger is empty — run `ig-tpu-torch bench run` first)"
    return fmt.format_table(rows)


def render_compare(results: list[CompareResult]) -> str:
    lines = []
    for r in results:
        mark = {"ok": "OK  ", "improved": "UP  ", "regression": "REGR",
                "no-baseline": "----", "refused": "REFU"}[r.status]
        lines.append(f"{mark} {r.config:18s} value={r.value:.4g} "
                     + (f"ratio={r.ratio:.3f} " if r.baseline else "")
                     + r.detail)
    return "\n".join(lines)
