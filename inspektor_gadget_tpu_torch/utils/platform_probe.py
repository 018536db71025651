"""Bounded-time device acquisition (PyTorch port of
``inspektor_gadget_tpu/utils/platform_probe.py``).

A process that will put state on the card (the agent, a run) asks here
first: `acquire_platform("cuda")` probes libcuda under a hard time
bound, so a wedged libcuda or a lost card stops the process with the
probe's detail instead of hanging at its first CUDA call.

The probe runs in a child process that calls the CUDA library
(``libcuda.so.1``) through ctypes: ``cuInit``, ``cuDeviceGetCount``,
``cuDeviceGetName``, the compute capability and the memory of each
card. The child imports neither torch nor anything of this package, so
it answers in well under a second, where importing torch takes seconds
on the card's slower hosts. A daemon thread supervises it, so even a
wedged spawn cannot hold the caller past `timeout`.

Where the reference degrades to the CPU when its probe fails or times
out, the port raises `PlatformError`: a CUDA run never falls back to the
CPU. The outcome, a failure too, is kept for `last_acquire()` (the
doctor's PLATFORM line, journal manifests), the flight recorder and the
``ig_platform_*`` metrics. ``cpu`` skips the probe.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable

from ..telemetry.registry import counter, gauge
from ..telemetry.tracing import RECORDER, TRACER
from .logger import get_logger

DEFAULT_PROBE_TIMEOUT = float(os.environ.get("IG_PLATFORM_PROBE_TIMEOUT", "20"))
# the retry's attempts and backoff horizon (seconds), the reference's defaults
DEFAULT_PROBE_ATTEMPTS = 3
DEFAULT_PROBE_HORIZON = 60.0
PLATFORMS = ("cuda", "cpu")

log = get_logger("ig-tpu.platform")

_tm_probes = counter("ig_platform_probe_total", "device platform probes by outcome",
                     ("outcome",))
_tm_failures = counter("ig_platform_failures_total",
                       "device acquisitions that failed (the port never degrades)")
_tm_info = gauge("ig_platform_info", "acquired device platform (1=current)", ("platform",))
_tm_degraded = gauge("ig_platform_degraded",
                     "always 0: a failed probe raises instead of degrading to the CPU")


class PlatformError(RuntimeError):
    """The device probe failed or timed out; `outcome` is what
    `last_acquire()` records."""

    def __init__(self, outcome: dict) -> None:
        super().__init__(f"{outcome['requested']} unavailable: {outcome['detail']}")
        self.outcome = outcome


@dataclasses.dataclass
class ProbeResult:
    ok: bool
    platform: str
    detail: str
    elapsed: float
    devices: list = dataclasses.field(default_factory=list)


# the last acquire_platform outcome, for the doctor and the flight record
_last_acquire: dict | None = None
_mu = threading.Lock()

# the child's program: libcuda's API through ctypes, one JSON line out
_PROBE_CODE = r"""
import ctypes, json, sys
lib = ctypes.CDLL("libcuda.so.1")
def err(rc):
    s = ctypes.c_char_p()
    lib.cuGetErrorName(rc, ctypes.byref(s))
    return f"CUDA error {rc} ({(s.value or b'?').decode()})"
rc = lib.cuInit(0)
if rc:
    sys.exit(f"cuInit failed: {err(rc)}")
n = ctypes.c_int()
rc = lib.cuDeviceGetCount(ctypes.byref(n))
if rc:
    sys.exit(f"cuDeviceGetCount failed: {err(rc)}")
devs = []
for i in range(n.value):
    d, major, minor = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    name, mem = ctypes.create_string_buffer(256), ctypes.c_size_t()
    lib.cuDeviceGet(ctypes.byref(d), i)
    lib.cuDeviceGetName(name, 256, d)
    lib.cuDeviceGetAttribute(ctypes.byref(major), 75, d)  # COMPUTE_CAPABILITY_MAJOR
    lib.cuDeviceGetAttribute(ctypes.byref(minor), 76, d)  # COMPUTE_CAPABILITY_MINOR
    lib.cuDeviceTotalMem_v2(ctypes.byref(mem), d)
    devs.append({"name": name.value.decode(), "cc": f"{major.value}.{minor.value}",
                 "mem_bytes": mem.value})
sys.stdout.write(json.dumps({"platform": "cuda", "devices": devs}))
"""


def last_acquire() -> dict | None:
    with _mu:
        return dict(_last_acquire) if _last_acquire else None


def describe(devices: list[dict]) -> str:
    """``N cuda device(s): name (cc X.Y, M GiB)[, ...]``."""
    cards = ", ".join(f"{d['name']} (cc {d['cc']}, {d['mem_bytes'] / (1 << 30):.1f} GiB)"
                      for d in devices)
    return f"{len(devices)} cuda device(s): {cards}"


def _subprocess_probe(timeout: float) -> ProbeResult:
    """Touch libcuda in a child process; the parent's timeout is the
    safety net a hanging libcuda cannot escape."""
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-c", _PROBE_CODE], capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return ProbeResult(False, "", f"probe timed out after {timeout:.0f}s",
                           time.perf_counter() - t0)
    except OSError as e:
        return ProbeResult(False, "", f"probe spawn failed: {e}", time.perf_counter() - t0)
    elapsed = time.perf_counter() - t0
    if p.returncode != 0:
        tail = (p.stderr or p.stdout or "").strip().splitlines()[-2:]
        return ProbeResult(False, "", "probe rc=%d: %s" % (p.returncode, " | ".join(tail)),
                           elapsed)
    try:
        doc = json.loads(p.stdout.strip().splitlines()[-1])
        devices = list(doc["devices"])
    except (ValueError, KeyError, IndexError):
        return ProbeResult(False, "", "probe produced no JSON", elapsed)
    if not devices:
        return ProbeResult(False, "", "libcuda answered with no CUDA device", elapsed)
    return ProbeResult(True, "cuda", f"{describe(devices)}; libcuda ok in {elapsed:.1f}s",
                       elapsed, devices)


def probe_device_platform(timeout: float = DEFAULT_PROBE_TIMEOUT,
                          probe_fn: Callable[[], ProbeResult] | None = None) -> ProbeResult:
    """Run the probe in a daemon thread and wait at most `timeout`. The
    thread bound holds even if `probe_fn` itself ignores deadlines: an
    unreachable card ends the wait within the timeout, never hangs the
    caller."""
    fn = probe_fn or (lambda: _subprocess_probe(timeout))
    box: list[ProbeResult] = []

    def run():
        try:
            box.append(fn())
        except Exception as e:  # noqa: BLE001 — a broken probe is a failed probe
            box.append(ProbeResult(False, "", f"probe raised: {e!r}", 0.0))

    t0 = time.perf_counter()
    t = threading.Thread(target=run, daemon=True, name="platform-probe")
    t.start()
    t.join(timeout)
    if not box:
        return ProbeResult(False, "", f"probe timed out after {timeout:.0f}s",
                           time.perf_counter() - t0)
    return box[0]


def _record(out: dict) -> None:
    global _last_acquire
    _tm_degraded.set(0.0)
    if out["ok"]:
        _tm_info.labels(platform=out["platform"]).set(1.0)
        RECORDER.set_fact("platform", out["platform"])
    RECORDER.set_fact("platform_probe", out)
    with _mu:
        _last_acquire = out


def acquire_platform(requested: str = "cuda", timeout: float = DEFAULT_PROBE_TIMEOUT,
                     probe_fn: Callable[[], ProbeResult] | None = None) -> dict:
    """Resolve ``cuda`` or ``cpu`` before the first device use.

    cpu: no probe. cuda: the bounded probe; an answer naming at least one
    card wins, anything else (a timeout, a crash, no card) raises
    `PlatformError` after it is recorded. Returns {requested, platform,
    degraded (always False), ok, detail, elapsed, devices}."""
    if requested not in PLATFORMS:
        raise ValueError(f"platform must be cuda|cpu, not {requested!r}")
    with TRACER.span("platform/acquire", attrs={"requested": requested}):
        if requested == "cpu":
            out = {"requested": requested, "platform": "cpu", "degraded": False, "ok": True,
                   "detail": "cpu requested", "elapsed": 0.0, "devices": []}
            _tm_probes.labels(outcome="skipped").inc()
        else:
            res = probe_device_platform(timeout, probe_fn)
            ok = res.ok and res.platform == "cuda"
            detail = res.detail if ok or not res.ok else f"probe answered {res.platform!r}"
            out = {"requested": requested, "platform": "cuda", "degraded": False, "ok": ok,
                   "detail": detail, "elapsed": res.elapsed, "devices": res.devices}
            _tm_probes.labels(outcome="ok" if ok else "failed").inc()
    _record(out)
    if not out["ok"]:
        _tm_failures.inc()
        log.error("device probe failed (%s); no CPU fallback", out["detail"])
        raise PlatformError(out)
    return out


def backoff_gaps(attempts: int, horizon: float) -> list[float]:
    """Sleep gaps between probe attempts: exponentially growing, summing
    to `horizon` (attempt 1 now, the rest spread so a short blip is
    retried quickly and a longer one still gets a late chance)."""
    n_gaps = max(attempts - 1, 0)
    if n_gaps == 0 or horizon <= 0:
        return [0.0] * n_gaps
    total = float((1 << n_gaps) - 1)  # 1 + 2 + 4 + ...
    return [horizon * (1 << i) / total for i in range(n_gaps)]


def acquire_platform_with_retry(requested: str = "cuda", attempts: int | None = None,
                                horizon: float | None = None,
                                timeout: float = DEFAULT_PROBE_TIMEOUT,
                                probe_fn: Callable[[], ProbeResult] | None = None,
                                sleep: Callable[[float], None] = time.sleep) -> dict:
    """`acquire_platform` with N probe attempts spread over a backoff
    horizon. Only probe failures are retried; the last failure raises
    `PlatformError`, never a CPU fallback. The outcome carries an
    `attempts` trail (on the error's `outcome` too)."""
    attempts = max(DEFAULT_PROBE_ATTEMPTS if attempts is None else attempts, 1)
    horizon = DEFAULT_PROBE_HORIZON if horizon is None else horizon
    if requested == "cpu":
        out = acquire_platform(requested, timeout, probe_fn)
        out["attempts"] = [{"attempt": 1, "ok": True, "platform": "cpu",
                            "detail": "cpu requested", "elapsed_s": 0.0}]
        return out
    gaps = backoff_gaps(attempts, horizon)
    trail: list[dict] = []
    res: ProbeResult | None = None
    for i in range(attempts):
        res = probe_device_platform(timeout, probe_fn)
        trail.append({"attempt": i + 1, "ok": res.ok, "platform": res.platform,
                      "detail": res.detail, "elapsed_s": round(res.elapsed, 3)})
        if res.ok:
            break
        if i < attempts - 1:
            log.warning("platform probe attempt %d/%d failed (%s); retrying in %.1fs",
                        i + 1, attempts, res.detail, gaps[i])
            sleep(gaps[i])
    RECORDER.set_fact("platform_probe_attempts", trail)
    try:
        out = acquire_platform(requested, timeout, probe_fn=lambda: res)
    except PlatformError as e:
        e.outcome["attempts"] = trail
        raise
    out["attempts"] = trail
    return out


__all__ = ["DEFAULT_PROBE_ATTEMPTS", "DEFAULT_PROBE_HORIZON", "DEFAULT_PROBE_TIMEOUT",
           "PLATFORMS", "PlatformError", "ProbeResult", "acquire_platform",
           "acquire_platform_with_retry", "backoff_gaps", "describe", "last_acquire",
           "probe_device_platform"]
