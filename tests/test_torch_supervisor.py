"""The port's stream supervision (`runtime/supervisor.py`) and the fan-out
runtime's params, on the CPU with no agent: the unit cases of
``tests/test_chaos_soak.py`` (retry policy shape and validation, error
classification, the runtime params' validators, the fleet-health state
machine with its straggler rule under an injected skewed clock, and
`NodeSupervisor`'s retry loop with its network seams stubbed out). The
counters read are the port's own registry's.
"""

from __future__ import annotations

import random

import pytest

from inspektor_gadget_tpu_torch.params import ParamError, Params
from inspektor_gadget_tpu_torch.runtime.grpc_runtime import GrpcRuntime
from inspektor_gadget_tpu_torch.runtime.supervisor import (
    DEAD, FATAL, HEALTHY, RECONNECTING, STRAGGLING, TRANSPORT, FleetHealth, RetryPolicy,
    classify_error,
)
from inspektor_gadget_tpu_torch.telemetry import REGISTRY
from inspektor_gadget_tpu_torch.testing.chaos import SkewClock


def _counter_value(name: str, **labels) -> float:
    """Sum of the family's samples matching every given label pair
    (label order in the exposition follows declaration, not the call)."""
    total = 0.0
    for key, v in REGISTRY.snapshot().items():
        if key != name and not key.startswith(name + "{"):
            continue
        if all(f'{k}="{lv}"' in key for k, lv in labels.items()):
            total += v
    return total


# ---------------------------------------------------------------------------
# retry policy + classification units
# ---------------------------------------------------------------------------

def test_retry_policy_backoff_shape():
    pol = RetryPolicy(base=0.1, cap=1.0, horizon=5.0, attempt_deadline=1.0,
                      rng=random.Random(7))
    # ceilings double then cap
    assert pol.ceiling(0) == pytest.approx(0.1)
    assert pol.ceiling(1) == pytest.approx(0.2)
    assert pol.ceiling(3) == pytest.approx(0.8)
    assert pol.ceiling(4) == pytest.approx(1.0)
    assert pol.ceiling(50) == pytest.approx(1.0)  # huge attempt, no overflow
    # full jitter: every delay lands in [0, ceiling] and they are not
    # all equal (the whole point is decorrelating reconnect stampedes)
    delays = [pol.delay(3) for _ in range(200)]
    assert all(0.0 <= d <= 0.8 for d in delays)
    assert len({round(d, 6) for d in delays}) > 50


def test_retry_policy_validation():
    with pytest.raises(ValueError):
        RetryPolicy(base=0.0)
    with pytest.raises(ValueError):
        RetryPolicy(base=1.0, cap=0.5)
    with pytest.raises(ValueError):
        RetryPolicy(horizon=0.0)
    with pytest.raises(ValueError):
        RetryPolicy(attempt_deadline=-1.0)


def test_error_classification():
    # transport trouble → retry with resume
    for err in ("UNAVAILABLE: connection reset", "DEADLINE_EXCEEDED: x",
                "ABORTED: peer", "INTERNAL: RST_STREAM",
                "channel not ready after 5.0s",
                "socket: connection refused"):
        assert classify_error(err) == TRANSPORT, err
    # deterministic failures → fatal, never retried
    for err in ("unknown gadget trace/nope", "INVALID_ARGUMENT: bad param",
                "gadget run failed: boom"):
        assert classify_error(err) == FATAL, err
    # a gadget-reported error is fatal even when the text looks netty
    assert classify_error("UNAVAILABLE: x", gadget_error=True) == FATAL
    assert classify_error(None) == FATAL


def test_stop_result_timeout_param_validated():
    rt = GrpcRuntime({})
    params = Params(rt.params())
    params.set("stop-result-timeout", "45s")
    assert params.get("stop-result-timeout").as_duration() == 45.0
    with pytest.raises(ParamError):
        params.set("stop-result-timeout", "0s")
    with pytest.raises(ParamError):
        params.set("stop-result-timeout", "banana")
    with pytest.raises(ParamError):
        params.set("retry-horizon", "-5s")


# ---------------------------------------------------------------------------
# fleet health state machine (injected clock, incl. skew)
# ---------------------------------------------------------------------------

def test_fleet_health_state_machine_and_straggler_p95():
    clk = SkewClock(base=lambda: 0.0)  # fully deterministic time
    h = FleetHealth(["a", "b", "c"], clock=clk, straggler_factor=4.0,
                    straggler_floor=0.5)
    assert h.states() == {"a": HEALTHY, "b": HEALTHY, "c": HEALTHY}
    # no cadence yet → no straggler threshold → nobody flagged
    clk.skew(100.0)
    assert h.check_stragglers() == []

    # establish a ~0.1s fleet cadence on a and b
    for _ in range(50):
        clk.skew(0.1)
        h.observe("a")
        h.observe("b")
    # c silent for 10× the cadence-derived threshold → straggling;
    # a and b stay healthy
    assert h.straggler_threshold() == pytest.approx(0.5)  # floor wins
    clk.skew(0.3)
    h.observe("a")
    h.observe("b")
    flagged = h.check_stragglers()
    assert flagged == ["c"]
    assert h.get("c") == STRAGGLING
    # a record from the straggler heals it
    h.observe("c")
    assert h.get("c") == HEALTHY

    # supervisor-owned transitions + resurrection on data
    h.mark("b", RECONNECTING)
    assert h.get("b") == RECONNECTING
    h.mark("b", DEAD)
    assert h.get("b") == DEAD
    h.observe("b")  # data after death = resurrection
    assert h.get("b") == HEALTHY

    # forward clock skew: one check may flag conservatively, the next
    # record heals — skew must never wedge a node unhealthy
    clk.skew(50.0)
    h.check_stragglers()
    h.observe("a")
    assert h.get("a") == HEALTHY
    # backward-looking: a backwards step must not poison the p95 with
    # negative intervals
    before = h.fleet_p95()
    clk.skew(-25.0)
    h.observe("a")
    assert h.fleet_p95() >= 0.0 if before is None else h.fleet_p95() >= 0.0

    # transitions counter saw the dead label
    assert _counter_value("ig_fleet_transitions_total", node="b",
                          to="dead") >= 1.0




def _stub_supervisor(attempts, *, done=lambda: False):
    """A NodeSupervisor with the network seams stubbed out: attempt
    results come from a scripted list, channel readiness is instant."""
    from inspektor_gadget_tpu_torch.runtime.supervisor import NodeSupervisor

    class _Client:
        def reconnect(self):
            pass

    health = FleetHealth(["n"], straggler_floor=0.1)
    sup = NodeSupervisor(
        "n", _Client(),
        policy=RetryPolicy(base=0.001, cap=0.002, horizon=0.5,
                           attempt_deadline=0.1),
        health=health, run_id="r", gadget="trace/exec", done=done,
        backfill=False)
    sup._wait_channel_ready = lambda: True
    calls = []

    def attempt(resume_from, rid):
        calls.append(resume_from)
        base = {"result": None, "error": None, "gaps": 0, "dropped": 0,
                "records": 0, "last_seq": 0, "resume": None,
                "unknown_run": False, "gadget_error": False}
        base.update(attempts[min(len(calls) - 1, len(attempts) - 1)])
        return base

    return sup, health, attempt, calls


def test_supervisor_fatal_gadget_error_not_retried():
    sup, health, attempt, calls = _stub_supervisor([
        {"error": "gadget run failed: boom", "gadget_error": True},
    ])
    out = sup.run(attempt)
    assert out["error"] == "gadget run failed: boom"
    assert len(calls) == 1, "fatal errors must not trigger the retry loop"
    assert out["reconnects"] == 0
    assert health.get("n") == DEAD


def test_supervisor_backfills_on_resume_missed_and_resets_outage():
    """A resume ack with missed>0 must trigger the sealed-window
    backfill for the outage interval, and a successful re-attach must
    CLEAR the outage clock — a later unrelated blip starts a fresh
    horizon instead of inheriting the first outage's start time."""
    sup, health, attempt, calls = _stub_supervisor([
        {"error": "UNAVAILABLE: cut", "last_seq": 40, "records": 40},
        {"error": "UNAVAILABLE: cut again", "last_seq": 70, "records": 25,
         "resume": {"run_id": "r", "missed": 5, "replayed": 25}},
        {"error": None, "last_seq": 90, "records": 20,
         "resume": {"run_id": "r", "missed": 0, "replayed": 0}},
    ])
    backfills = []
    sup._backfill_enabled = True
    sup._backfill = lambda since, until, out: backfills.append((since, until))
    out = sup.run(attempt)
    assert out["error"] is None
    # exactly one backfill: the missed-5 re-attach; the missed-0 one not
    assert len(backfills) == 1
    since, until = backfills[0]
    assert since < until
    assert health.get("n") == HEALTHY
    assert calls == [None, 40, 70]


def test_supervisor_unknown_run_restarts_seq_space():
    """After an agent respawn (unknown_run) the new life numbers its
    stream from 1: the supervisor must reset its resume baseline, not
    resume the new ring from the dead life's high seq."""
    sup, health, attempt, calls = _stub_supervisor([
        {"error": "UNAVAILABLE: killed", "last_seq": 40, "records": 40},
        {"error": "unknown run 'r'", "unknown_run": True},
        {"error": "UNAVAILABLE: flap", "last_seq": 0, "records": 0},
        {"error": None, "last_seq": 30, "records": 30,
         "resume": {"run_id": "r", "missed": 0, "replayed": 30}},
    ])
    out = sup.run(attempt)
    assert out["error"] is None
    # after unknown_run: fresh start (None), then resume from the NEW
    # life's baseline 0 — never from the dead life's 40
    assert calls == [None, 40, None, 0]
    assert out["last_seq"] == 30
    assert out["records"] == 70


def test_supervisor_resumes_transport_errors_until_clean():
    sup, health, attempt, calls = _stub_supervisor([
        {"error": "UNAVAILABLE: cut", "last_seq": 40, "records": 40},
        {"error": "UNAVAILABLE: still down"},
        {"error": None, "last_seq": 90, "records": 50,
         "resume": {"run_id": "r", "missed": 0, "replayed": 10}},
    ])
    out = sup.run(attempt)
    assert out["error"] is None
    # first attempt fresh, then resume-from-40 on every retry
    assert calls == [None, 40, 40]
    assert out["reconnects"] == 2
    assert out["records"] == 90 and out["last_seq"] == 90
    assert health.get("n") == HEALTHY
