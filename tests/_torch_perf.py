"""Test helper for the perf plane's parity tests: records built alike
for both packages, and the probe state each harness run leaves behind.

Both packages' `acquire_platform` keep the last outcome in a module
global that journal manifests read; a test that runs a harness or a
bench module restores it (`probe_state`, autouse where imported).
"""

from __future__ import annotations

import pytest


def prov(platform="tpu", degraded=False, sha="deadbeef") -> dict:
    return {
        "git_sha": sha, "git_dirty": False,
        "host": {"hostname": "h", "machine": "x86_64", "python": "3.12"},
        "platform": platform, "degraded": degraded,
        "probe": {"outcome": "ok", "attempts": []},
    }


def rec(schema, value, platform="tpu", degraded=False, config="bench.e2e", ts=None,
        **kw) -> dict:
    """A throughput record made by `schema` (either package's module)."""
    return schema.make_record(
        config=config, metric=kw.pop("metric", "sketch_ingest_throughput_e2e"),
        unit=kw.pop("unit", "events/sec/chip"), value=value,
        stages=kw.pop("stages", {"pop": {"ev_per_s": value * 1.5, "seconds": 1.0}}),
        provenance=prov(platform, degraded),
        ts=ts or f"2026-08-0{1 + (int(value) % 8)}T00:00:00+00:00", **kw)


@pytest.fixture(autouse=True)
def probe_state():
    from inspektor_gadget_tpu.utils import platform_probe as RP
    from inspektor_gadget_tpu_torch.utils import platform_probe as PP
    before = PP._last_acquire, RP._last_acquire
    yield
    PP._last_acquire, RP._last_acquire = before
