"""The port's bounded device probe (`utils/platform_probe.py`) against the
reference's (tests/test_tracing.py, the platform-probe cases).

Where the reference degrades to the CPU, the port raises
`PlatformError`, within the same bound, and records the failure in
`last_acquire()`, the flight recorder and the ``ig_platform_*`` metrics.
`backoff_gaps` and the retry's attempts and horizon are the reference's.
This host has no card: the real probe's child finds no libcuda and the
error carries its detail.
"""

from __future__ import annotations

import time

import pytest

from inspektor_gadget_tpu.utils import platform_probe as RP
from inspektor_gadget_tpu_torch.telemetry import snapshot
from inspektor_gadget_tpu_torch.telemetry.tracing import RECORDER
from inspektor_gadget_tpu_torch.utils import platform_probe as PP


@pytest.fixture(autouse=True)
def keep_acquire_state():
    """Every test leaves `last_acquire()` as it found it (journal
    manifests elsewhere in this process read it)."""
    before, ref_before = PP._last_acquire, RP._last_acquire
    yield
    PP._last_acquire, RP._last_acquire = before, ref_before


def _ok(devices=None):
    devices = devices or [{"name": "NVIDIA H100 80GB HBM3", "cc": "9.0",
                           "mem_bytes": 85 << 30}]
    return lambda: PP.ProbeResult(True, "cuda", PP.describe(devices), 0.1, devices)


def test_a_hanging_probe_raises_within_its_timeout():
    failures = PP._tm_failures.value

    def hanging_probe():
        time.sleep(30)  # libcuda wedged in cuInit
        return PP.ProbeResult(True, "cuda", "", 30.0)

    t0 = time.monotonic()
    with pytest.raises(PP.PlatformError, match="timed out") as err:
        PP.acquire_platform("cuda", timeout=0.3, probe_fn=hanging_probe)
    assert time.monotonic() - t0 < 5.0
    assert err.value.outcome["ok"] is False and err.value.outcome["degraded"] is False
    assert PP._tm_failures.value == failures + 1
    last = PP.last_acquire()
    assert last["requested"] == "cuda" and not last["ok"] and "timed out" in last["detail"]
    assert RECORDER.snapshot()["facts"]["platform_probe"]["ok"] is False


def test_the_reference_degrades_where_the_port_raises():
    """The same hanging probe: the reference pins the CPU, the port
    raises; both within the bound and with the same detail."""
    def hang():
        time.sleep(30)

    ref = RP.acquire_platform("auto", timeout=0.3, probe_fn=hang)
    assert ref["platform"] == "cpu" and ref["degraded"] is True
    with pytest.raises(PP.PlatformError) as err:
        PP.acquire_platform("cuda", timeout=0.3, probe_fn=hang)
    assert err.value.outcome["detail"] == ref["detail"] == "probe timed out after 0s"


def test_probe_outcomes():
    out = PP.acquire_platform("cuda", timeout=5.0, probe_fn=_ok())
    assert out == {"requested": "cuda", "platform": "cuda", "degraded": False, "ok": True,
                   "detail": "1 cuda device(s): NVIDIA H100 80GB HBM3 (cc 9.0, 85.0 GiB)",
                   "elapsed": 0.1, "devices": out["devices"]}
    assert PP.last_acquire() == out
    assert snapshot()['ig_platform_info{platform="cuda"}'] == 1.0
    assert snapshot()["ig_platform_degraded"] == 0.0
    assert RECORDER.snapshot()["facts"]["platform"] == "cuda"
    # a probe that answers without a card is a failure, not a CPU platform
    with pytest.raises(PP.PlatformError, match="probe answered 'cpu'"):
        PP.acquire_platform("cuda", probe_fn=lambda: PP.ProbeResult(True, "cpu", "", 0.1))
    # cpu requested: the probe never runs
    calls = []
    out = PP.acquire_platform("cpu", probe_fn=lambda: calls.append(1))
    assert out["platform"] == "cpu" and out["ok"] and not calls
    assert out["detail"] == "cpu requested"
    for bad in ("auto", "tpu", "gpu"):
        with pytest.raises(ValueError, match="cuda\\|cpu"):
            PP.acquire_platform(bad)


def test_a_broken_probe_is_a_failed_probe():
    def boom():
        raise OSError("libcuda.so.1: cannot open shared object file")

    with pytest.raises(PP.PlatformError, match="probe raised"):
        PP.acquire_platform("cuda", timeout=5.0, probe_fn=boom)


def test_the_real_probe_on_a_host_without_a_card():
    """The child calls libcuda through ctypes and imports no torch: here
    it fails fast with the loader's detail, within its bound."""
    t0 = time.monotonic()
    res = PP._subprocess_probe(30.0)
    assert time.monotonic() - t0 < 30.0
    assert not res.ok and res.detail.startswith("probe rc=1")
    assert "libcuda" in res.detail or "cuInit" in res.detail
    assert "import torch" not in PP._PROBE_CODE
    with pytest.raises(PP.PlatformError, match="probe rc=1"):
        PP.acquire_platform("cuda", timeout=30.0)


def test_backoff_gaps_are_the_references():
    for attempts, horizon in ((3, 60.0), (1, 60.0), (5, 10.0), (4, 0.0), (0, 5.0)):
        assert PP.backoff_gaps(attempts, horizon) == RP.backoff_gaps(attempts, horizon)
    assert PP.DEFAULT_PROBE_ATTEMPTS == RP.DEFAULT_PROBE_ATTEMPTS
    assert PP.DEFAULT_PROBE_HORIZON == RP.DEFAULT_PROBE_HORIZON
    assert PP.DEFAULT_PROBE_TIMEOUT == RP.DEFAULT_PROBE_TIMEOUT


def test_retry_ends_in_the_error_with_the_trail():
    sleeps = []
    fail = PP.ProbeResult(False, "", "probe rc=1: no libcuda", 0.01)
    with pytest.raises(PP.PlatformError) as err:
        PP.acquire_platform_with_retry("cuda", attempts=3, horizon=7.0, timeout=5.0,
                                       probe_fn=lambda: fail, sleep=sleeps.append)
    assert sleeps == PP.backoff_gaps(3, 7.0) == [7.0 / 3, 14.0 / 3]
    trail = err.value.outcome["attempts"]
    assert [a["attempt"] for a in trail] == [1, 2, 3] and not any(a["ok"] for a in trail)
    assert RECORDER.snapshot()["facts"]["platform_probe_attempts"] == trail
    # the reference, on the same failures, degrades after as many attempts
    ref_sleeps = []
    ref = RP.acquire_platform_with_retry("auto", attempts=3, horizon=7.0, timeout=5.0,
                                         probe_fn=lambda: RP.ProbeResult(False, "", "x", 0.0),
                                         sleep=ref_sleeps.append)
    assert ref_sleeps == sleeps and len(ref["attempts"]) == 3 and ref["degraded"]


def test_retry_stops_at_the_first_answer():
    results = iter([PP.ProbeResult(False, "", "blip", 0.01), _ok()()])
    sleeps = []
    out = PP.acquire_platform_with_retry("cuda", attempts=3, horizon=3.0,
                                         probe_fn=lambda: next(results), sleep=sleeps.append)
    assert out["ok"] and out["platform"] == "cuda" and len(out["attempts"]) == 2
    assert sleeps == [1.0]
    out = PP.acquire_platform_with_retry("cpu", probe_fn=lambda: 1 / 0)
    assert out["platform"] == "cpu" and out["attempts"][0]["detail"] == "cpu requested"


def test_journal_manifests_take_the_acquired_platform():
    from inspektor_gadget_tpu_torch.capture.journal import build_manifest
    PP._last_acquire = None
    assert build_manifest(platform="cpu")["platform"] == "cpu"
    assert build_manifest()["platform"] == "unprobed"
    PP.acquire_platform("cuda", probe_fn=_ok())
    m = build_manifest(platform="cpu")
    assert m["platform"] == "cuda" and m["degraded"] is False
    with pytest.raises(PP.PlatformError):
        PP.acquire_platform("cuda", probe_fn=lambda: PP.ProbeResult(False, "", "x", 0.0))
    assert build_manifest(platform="cpu")["platform"] == "cpu"  # a failure is no platform
