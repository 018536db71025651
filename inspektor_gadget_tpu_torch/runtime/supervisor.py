"""Stream supervision: retry policy, error classes, and fleet health.

The fan-out runtime used to *isolate* node failures (record the error,
move on) but never *recover*: a dropped stream stayed dead for the rest
of the run. This module is the recovery half — the pieces GrpcRuntime
composes around each node stream:

  - RetryPolicy: capped exponential backoff with FULL jitter (AWS
    architecture-blog discipline: sleep = uniform(0, min(cap, base*2^n))
    so N reconnecting clients don't stampede the healing agent on the
    same tick), plus a per-attempt connect deadline and a "horizon"
    after which a still-unreachable node is *labeled* dead. Labeling is
    not giving up: the supervisor keeps retrying at the capped rate for
    as long as the run lives, so a partition that outlasts the horizon
    still heals (resurrection) — "dead" is an honest state, not a
    terminal one.
  - classify_error: retryable transport trouble vs fatal gadget errors.
    Retrying a broken gadget spec would loop forever on a determinist
    failure; giving up on a flaky network wastes a healthy node.
  - FleetHealth: the per-node state machine
    healthy | reconnecting | straggling | dead, with straggler
    detection keyed to the *fleet's* rolling inter-record p95 (a slow
    node is slow relative to its peers, not to a wall-clock constant)
    and an injectable clock so chaos tests can skew time.
  - NodeSupervisor: the retry loop itself — resume-first (re-attach to
    the still-running gadget at last_seq), restart-on-unknown-run (the
    agent was respawned; capture restarts), and seq-gap healing via the
    history plane's sealed-window backfill merge (the windows' merge algebra:
    everything is mergeable, so rejoin = fetch-and-merge, never
    re-stream from zero).

The port's copy of ``inspektor_gadget_tpu/runtime/supervisor.py``: the
same classes, states and ``ig_fleet_*`` metrics, in the port's own
telemetry registry.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable

from ..telemetry import counter, gauge

# -- telemetry (fleet plane) ------------------------------------------------

_tm_node_state = gauge(
    "ig_fleet_node_state",
    "per-node fleet health (1 for the node's current state)",
    ("node", "state"))
_tm_transitions = counter(
    "ig_fleet_transitions_total",
    "fleet health state transitions", ("node", "to"))
_tm_reconnects = counter(
    "ig_fleet_reconnects_total",
    "stream reconnect attempts per node", ("node",))
_tm_backfilled = counter(
    "ig_fleet_backfilled_records_total",
    "records recovered into merged state from sealed-window backfill "
    "after an outage", ("node",))

HEALTHY = "healthy"
RECONNECTING = "reconnecting"
STRAGGLING = "straggling"
DEAD = "dead"
STATES = (HEALTHY, RECONNECTING, STRAGGLING, DEAD)


# -- error classification ---------------------------------------------------

# gRPC status codes that mean "the transport or peer hiccupped, the same
# request can succeed later" (the reference's connection-level retries);
# everything else — and any error the gadget itself reported via
# EV_RESULT — is fatal: retrying re-runs a deterministic failure.
RETRYABLE_CODES = frozenset({
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "RESOURCE_EXHAUSTED",
    "UNKNOWN", "INTERNAL", "CANCELLED",
})

TRANSPORT = "transport"
FATAL = "fatal"


def classify_error(error: str | None, *, gadget_error: bool = False) -> str:
    """'transport' (retry with resume) or 'fatal' (record and stop).

    Client stream errors arrive as "CODE_NAME: details" strings
    (AgentClient formats grpc.RpcError that way); anything that doesn't
    parse to a known-retryable code — a gadget raising, a bad param, an
    unknown gadget — is fatal.
    """
    if gadget_error or not error:
        return FATAL
    code = error.split(":", 1)[0].strip()
    if code in RETRYABLE_CODES:
        return TRANSPORT
    # socket-level failures surfaced outside grpc status codes
    lowered = error.lower()
    if any(s in lowered for s in ("connection refused", "connection reset",
                                  "broken pipe", "unreachable", "timed out",
                                  "channel not ready", "eof")):
        return TRANSPORT
    return FATAL


# -- retry policy -----------------------------------------------------------

class RetryPolicy:
    """Capped exponential backoff with full jitter + attempt deadline.

    base/cap/horizon/attempt_deadline in seconds. `horizon` is how long
    a node may stay unreachable before being LABELED dead (retries
    continue at the capped rate — see module docstring). rng is
    injectable for deterministic tests.
    """

    def __init__(self, *, base: float = 0.2, cap: float = 3.0,
                 horizon: float = 30.0, attempt_deadline: float = 5.0,
                 rng: random.Random | None = None):
        if base <= 0 or cap < base:
            raise ValueError(f"retry base/cap out of range ({base}, {cap})")
        if horizon <= 0 or attempt_deadline <= 0:
            raise ValueError("retry horizon/attempt deadline must be > 0")
        self.base = float(base)
        self.cap = float(cap)
        self.horizon = float(horizon)
        self.attempt_deadline = float(attempt_deadline)
        self._rng = rng or random.Random()

    def ceiling(self, attempt: int) -> float:
        """Deterministic upper bound of the attempt-th sleep (attempt
        counts from 0)."""
        return min(self.cap, self.base * (2 ** min(attempt, 32)))

    def delay(self, attempt: int) -> float:
        """Full jitter: uniform over (0, ceiling]."""
        return self._rng.uniform(0.0, self.ceiling(attempt))


# -- fleet health -----------------------------------------------------------

class FleetHealth:
    """Per-node state machine over a shared fleet record cadence.

    A node is `straggling` when it has been silent for more than
    straggler_factor × the fleet's rolling inter-record p95 (floored at
    straggler_floor so a quiet-but-uniform fleet doesn't flap on µs
    cadences). observe() — a record arrived — heals any state back to
    healthy; the supervisor marks reconnecting/dead around stream
    outages. The clock is injectable (chaos tests skew it).
    """

    def __init__(self, nodes, *, clock: Callable[[], float] = time.monotonic,
                 straggler_factor: float = 4.0, straggler_floor: float = 1.0,
                 window: int = 256):
        self._clock = clock
        self.straggler_factor = float(straggler_factor)
        self.straggler_floor = float(straggler_floor)
        self._mu = threading.Lock()
        now = clock()
        self._state: dict[str, str] = {}
        self._last_seen: dict[str, float] = {n: now for n in nodes}
        self._intervals: list[float] = []
        self._window = int(window)
        self._finished: set[str] = set()
        for n in nodes:
            self._state[n] = HEALTHY
            self._export(n, HEALTHY)

    def _export(self, node: str, state: str) -> None:
        for s in STATES:
            _tm_node_state.labels(node=node, state=s).set(
                1.0 if s == state else 0.0)

    def _set_locked(self, node: str, state: str) -> None:
        if self._state.get(node) == state:
            return
        self._state[node] = state
        _tm_transitions.labels(node=node, to=state).inc()
        self._export(node, state)

    def mark(self, node: str, state: str) -> None:
        if state not in STATES:
            raise ValueError(f"unknown fleet state {state!r}")
        with self._mu:
            self._set_locked(node, state)

    def observe(self, node: str) -> None:
        """A record arrived from `node`: refresh cadence, heal state."""
        now = self._clock()
        with self._mu:
            last = self._last_seen.get(node, now)
            self._last_seen[node] = now
            dt = now - last
            if dt >= 0:  # a backwards clock skew must not poison the p95
                self._intervals.append(dt)
                if len(self._intervals) > self._window:
                    del self._intervals[: -self._window]
            self._set_locked(node, HEALTHY)

    def fleet_p95(self) -> float | None:
        with self._mu:
            if not self._intervals:
                return None
            s = sorted(self._intervals)
        return s[min(len(s) - 1, int(0.95 * len(s)))]

    def straggler_threshold(self) -> float:
        p95 = self.fleet_p95()
        if p95 is None:
            return float("inf")
        return max(self.straggler_factor * p95, self.straggler_floor)

    def finish(self, node: str) -> None:
        """The node's stream ended for good: silence is now expected,
        so straggler checks must leave its final state alone."""
        with self._mu:
            self._finished.add(node)

    def check_stragglers(self) -> list[str]:
        """Flag healthy-but-silent nodes; returns newly straggling."""
        thr = self.straggler_threshold()
        now = self._clock()
        flagged = []
        with self._mu:
            for node, st in self._state.items():
                if node in self._finished:
                    continue
                if st == HEALTHY and now - self._last_seen[node] > thr:
                    self._set_locked(node, STRAGGLING)
                    flagged.append(node)
        return flagged

    def get(self, node: str) -> str:
        with self._mu:
            return self._state.get(node, HEALTHY)

    def states(self) -> dict[str, str]:
        with self._mu:
            return dict(self._state)

    def silence(self, node: str) -> float:
        with self._mu:
            return self._clock() - self._last_seen.get(node, self._clock())


# -- the per-node supervision loop ------------------------------------------

class NodeSupervisor:
    """Run one node's stream to completion through chaos.

    attempt_fn(resume_from: int | None, run_id: str) -> dict is the
    blocking stream call (AgentClient.run_gadget with all handlers
    wired); it returns the client's accounting dict ({'error',
    'last_seq', 'records', 'gaps', 'dropped', 'unknown_run', 'resume',
    'result'}). The supervisor owns retries, resume bookkeeping, health
    transitions, and sealed-window backfill, and returns one merged
    accounting dict for the node's GadgetResult.
    """

    def __init__(self, node: str, client: Any, *, policy: RetryPolicy,
                 health: FleetHealth, run_id: str, gadget: str,
                 done: Callable[[], bool], logger=None,
                 backfill: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.node = node
        self.client = client
        self.policy = policy
        self.health = health
        self.run_id = run_id
        self.gadget = gadget
        # the agent-assigned subscriber id, learned from attach/resume
        # acks: a resume must name WHICH subscriber is reconnecting, or
        # a shared run would resolve it to the wrong peer's stream
        self.sub_id = ""
        self._done = done
        self._log = logger
        self._backfill_enabled = backfill
        self._clock = clock
        self._wall = wall_clock

    # small seams the chaos tests poke through --------------------------

    def _sleep(self, seconds: float) -> None:
        deadline = self._clock() + seconds
        while not self._done() and self._clock() < deadline:
            time.sleep(min(0.05, max(0.0, deadline - self._clock())))

    def _wait_channel_ready(self) -> bool:
        """Per-attempt deadline: bound the connect wait so a blackholed
        peer consumes one backoff slot, not the whole run."""
        import grpc
        try:
            grpc.channel_ready_future(self.client.channel).result(
                timeout=self.policy.attempt_deadline)
            return True
        except Exception:  # noqa: BLE001 — timeout or terminal channel
            return False

    def _backfill(self, since_wall: float, until_wall: float,
                  out: dict) -> None:
        """Heal a seq gap from sealed windows: every window the node
        sealed during the outage is mergeable state (the merge algebra), so
        the gap's events rejoin the merged answer without re-streaming.
        Only windows already sealed are recoverable — the torn tail of
        a SIGKILLed store is dropped-and-accounted by the store reader,
        never silently resurrected."""
        if not self._backfill_enabled:
            return
        try:
            from ..history import decode_frames
            listing = self.client.list_windows(
                gadget=self.gadget, start_ts=since_wall, end_ts=until_wall)
            if not listing.get("windows"):
                return
            frames, _losses = self.client.fetch_windows(
                gadget=self.gadget, start_ts=since_wall, end_ts=until_wall)
            # THIS run's windows only: a concurrent run of the same
            # gadget seals into the same store, and merging its windows
            # here would smuggle another run's events into this result.
            # (An unknown-run restart reuses the run_id, so the dead
            # life's windows still match.)
            wins = [w for w in decode_frames(frames)
                    if not w.run_id or w.run_id == self.run_id]
        except Exception as e:  # noqa: BLE001 — backfill is best-effort
            if self._log:
                self._log.warning("[%s] backfill failed: %r", self.node, e)
            return
        events = sum(int(w.events) for w in wins)
        if wins:
            out["backfill"].extend(wins)
            out["backfilled"] += events
            _tm_backfilled.labels(node=self.node).inc(events)
            if self._log:
                self._log.info(
                    "[%s] backfilled %d sealed window(s), %d record(s) "
                    "covering the outage", self.node, len(wins), events)

    # the loop ----------------------------------------------------------

    def run(self, attempt_fn: Callable[[int | None, str], dict]) -> dict:
        out: dict[str, Any] = {
            "result": None, "error": None, "gaps": 0, "dropped": 0,
            "records": 0, "last_seq": 0, "reconnects": 0,
            "backfilled": 0, "backfill": [],
            # shared-run subscriber accounting, aggregated across
            # reconnect attempts (drop totals are cumulative per
            # subscriber, so max — not sum — across attempts)
            "sub_drops": 0, "evicted": False, "attach_refused": "",
            "attach": None,
        }
        resume_from: int | None = None
        attempt = 0                    # consecutive failed attempts
        outage_wall: float | None = None
        outage_mono: float | None = None

        while True:
            if attempt > 0:
                # reconnect path: fresh channel + bounded connect wait
                out["reconnects"] += 1
                _tm_reconnects.labels(node=self.node).inc()
                over_horizon = (outage_mono is not None and self._clock()
                                - outage_mono >= self.policy.horizon)
                self.health.mark(self.node,
                                 DEAD if over_horizon else RECONNECTING)
                try:
                    self.client.reconnect()
                except Exception as e:  # noqa: BLE001 — treat as failed dial
                    if self._log:
                        self._log.debug("[%s] redial failed: %r",
                                        self.node, e)
                if not self._wait_channel_ready():
                    if self._done():
                        break
                    if (outage_mono is not None and self._clock()
                            - outage_mono >= self.policy.horizon):
                        self.health.mark(self.node, DEAD)
                    self._sleep(self.policy.delay(attempt))
                    attempt += 1
                    continue

            res = attempt_fn(resume_from, self.run_id)
            out["gaps"] += int(res.get("gaps") or 0)
            out["dropped"] += int(res.get("dropped") or 0)
            out["records"] += int(res.get("records") or 0)
            out["sub_drops"] = max(out["sub_drops"],
                                   int(res.get("sub_drops") or 0))
            out["evicted"] = out["evicted"] or bool(res.get("evicted"))
            if res.get("attach_refused"):
                out["attach_refused"] = res["attach_refused"]
            if res.get("attach") is not None:
                out["attach"] = res["attach"]
                if res["attach"].get("sub_id"):
                    self.sub_id = res["attach"]["sub_id"]
            if res.get("last_seq"):
                out["last_seq"] = int(res["last_seq"])
            if res.get("result") is not None:
                out["result"] = res["result"]

            ack = res.get("resume") or {}
            if ack.get("sub_id"):
                self.sub_id = ack["sub_id"]
            was_reconnect = attempt > 0
            if int(res.get("records") or 0) > 0 or ack:
                # the attempt made real progress: later, unrelated
                # outages must start backoff from base again, not from
                # this outage's accumulated exponent
                attempt = 0
            if was_reconnect and ack and outage_wall is not None:
                # re-attached to the still-running gadget; anything the
                # replay ring could not cover is healed from sealed state
                if int(ack.get("missed") or 0) > 0:
                    self._backfill(outage_wall - 1.0, self._wall() + 1.0,
                                   out)
                outage_wall = outage_mono = None

            if res.get("unknown_run"):
                # the agent restarted underneath us: nothing to resume.
                # Recover what its previous life sealed to disk, then
                # restart capture fresh (rejoin = backfill-and-merge).
                since = (outage_wall - 1.0 if outage_wall is not None
                         else self._wall() - self.policy.horizon)
                self._backfill(since, self._wall() + 1.0, out)
                resume_from = None
                self.sub_id = ""  # the fresh run assigns a new identity
                # the respawned agent numbers its NEW life's stream from
                # seq 1: resuming (or gap-counting) against the dead
                # life's high seq would silently skip the new ring
                out["last_seq"] = 0
                outage_wall = outage_mono = None
                if self._done():
                    out["error"] = out["error"] or res.get("error")
                    break
                attempt += 1
                self._sleep(self.policy.delay(attempt))
                continue

            err = res.get("error")
            if not err:
                # clean stream end
                self.health.mark(self.node, HEALTHY)
                out["error"] = None
                break

            cls = classify_error(err, gadget_error=bool(res.get(
                "gadget_error")))
            if cls == FATAL:
                out["error"] = err
                self.health.mark(self.node, DEAD)
                break

            # retryable transport trouble: resume from where we stopped.
            # Always resume (even at last_seq 0) once a run request went
            # out — a fresh re-run against an agent whose previous life
            # still lingers would capture TWICE under one run_id; if the
            # run never actually started over there, the resume answers
            # unknown_run and we restart cleanly above.
            out["error"] = err  # kept only if we never recover
            if outage_mono is None:
                outage_mono = self._clock()
                outage_wall = self._wall()
            if self._done():
                break
            resume_from = int(out["last_seq"] or 0)
            attempt += 1
            self._sleep(self.policy.delay(attempt))

        # final label: a node that never healed ends dead with its last
        # error; a clean node ends healthy with error None
        if out["error"] is not None:
            self.health.mark(self.node, DEAD)
        return out


__all__ = [
    "DEAD", "FATAL", "FleetHealth", "HEALTHY", "NodeSupervisor",
    "RECONNECTING", "RETRYABLE_CODES", "RetryPolicy", "STATES",
    "STRAGGLING", "TRANSPORT", "classify_error",
]
