"""Agent server: the per-node gRPC service.

Reference contract (pkg/gadget-service/service.go): RunGadget :78-249 —
parse the run request, split the flat params map by prefix, build a
GadgetContext, pump events through a bounded 1024 buffer with drop-on-full
(:134-168), a sender goroutine forwards to the stream (:170-181), logs ride
the same stream with severity in the type bits (gadget-service/logger.go);
plus the container hooks service (gadgettracermanager.go AddContainer:151)
and a health service (daemon main.go:224-245).

gRPC methods are registered with generic handlers + identity serializers;
message bodies use wire.py framing.

Shared-run plane (ISSUE 12): a run is a first-class shared resource —
SharedRun fans one gadget's stream out to N reference-counted
Subscribers, each with its own seq space, bounded queue, drop policy,
priority class, and evict-after stall window; admission control bounds
subscriber count and queued capacity (low priority refused first), and
the last detach starts a keepalive countdown instead of killing the
capture. See docs/robustness.md "Shared runs & overload".

The port's copy of ``inspektor_gadget_tpu/agent/service.py``, with one
design change: the agent has a ``device``. `AgentServer` and `serve`
resolve it once at start-up (`device.resolve_device`: ``cuda`` without a
card raises before anything listens), and every GadgetContext the agent
builds, RunGadget's and the Trace resources', takes it. `serve` returns
the port it bound and raises where gRPC could not bind the address.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
from concurrent import futures
from typing import Iterator

import grpc

from .. import all_gadgets  # noqa: F401
from ..containers import Container
from ..device import resolve_device
from ..gadgets import GadgetContext
from ..gadgets import registry as gadget_registry
from ..gadgets.interface import GadgetType
from ..operators import operators as op_registry
from ..params import Collection
from ..runtime.local import LocalRuntime
from ..runtime.runtime import build_catalog
from ..telemetry import counter, gauge
from ..telemetry.tracing import RECORDER, TRACER
from ..utils.logger import StreamLogHandler, StreamLogger
from . import wire

EVENT_BUFFER = 1024  # ref: service.go:134 bounded buffer, drop-on-full

# resume plane defaults: how many outbound messages a detached run
# retains for ring replay, and how long a resumable run keeps running
# with no client attached before it cancels itself. Both are per-run
# overridable via the run request (`ring` / `linger`).
RESUME_RING = 1024
RESUME_LINGER = 10.0

# shared-run overload defaults (per-run / per-subscriber overridable via
# the run request — validated loudly both here and in the client params
# layer): bounded per-subscriber queues with an explicit drop policy, a
# per-run subscriber count + queued-capacity budget, and a stall window
# after which a wedged subscriber is EVICTED with a labeled terminal
# record instead of silently rotting.
SUB_QUEUE = EVENT_BUFFER
MAX_SUBSCRIBERS = 16
SUB_BUDGET = 16384              # total queued-message capacity per run
EVICT_AFTER = 10.0
DROP_POLICIES = wire.DROP_POLICIES
PRIORITIES = wire.PRIORITIES
TIERS = wire.TIERS
# admission headroom: the fraction of the run's subscriber budget a
# class may fill — low-priority admissions are refused FIRST as the run
# approaches saturation (PSketch-style priority classes under a fixed
# budget), so the important consumers stay whole.
ADMIT_HEADROOM = {"high": 1.0, "normal": 0.85, "low": 0.6}

log = logging.getLogger("ig-tpu.agent")


def handlers_for(gadget_type, outputs, on_event, on_event_array):
    """Gadget type → stream handler wiring for a RunGadget stream.

    Raises ValueError for a type this agent does not know how to serve:
    before this existed, an unknown type silently got no handlers and
    the client watched an empty stream end cleanly (VERDICT Weak #7 —
    the advise/traceloop mislabel rode exactly that hole)."""
    if gadget_type == GadgetType.TRACE:
        return on_event, None
    if gadget_type == GadgetType.TRACE_INTERVALS:
        return None, on_event_array
    if gadget_type == GadgetType.ONE_SHOT:
        return None, (on_event_array if "combiner" in outputs else None)
    if gadget_type in (GadgetType.PROFILE, GadgetType.START_STOP):
        # run-with-result gadgets: the final rendered bytes ride the
        # stream as EV_RESULT; no per-event handlers exist to wire
        return None, None
    raise ValueError(
        f"agent has no handler wiring for gadget type {gadget_type!r} "
        f"(outputs={sorted(outputs)}): refusing to serve a stream that "
        f"would silently carry no events")

# per-stream RPC telemetry (one lock touch per message, never per event —
# a message carries a whole batch/array)
_tm_rpc = counter("ig_agent_rpc_total", "agent RPCs served", ("method",))
_tm_stream_msgs = counter("ig_agent_stream_msgs_total",
                          "messages pushed onto RunGadget streams",
                          ("gadget",))
_tm_stream_dropped = counter("ig_agent_stream_dropped_total",
                             "stream messages dropped on backpressure",
                             ("gadget",))
_tm_stream_q = gauge("ig_agent_stream_queue_depth",
                     "RunGadget out-queue depth at last push (backpressure)",
                     ("gadget",))
_tm_active_runs = gauge("ig_agent_active_runs", "gadget runs in flight")
_tm_stream_resumes = counter("ig_agent_stream_resumes_total",
                             "RunGadget streams re-attached via resume",
                             ("gadget",))
_tm_detached_runs = gauge("ig_agent_detached_runs",
                          "resumable runs currently lingering with no "
                          "client attached")
# shared-run / overload-protection plane
_tm_run_subs = gauge("ig_agent_run_subscribers",
                     "live subscribers per shared gadget run", ("run",))
_tm_sub_drops = counter("ig_agent_subscriber_drops_total",
                        "records dropped by a slow subscriber's own "
                        "bounded queue (never stalls the gadget or its "
                        "peers)", ("run", "policy", "class"))
_tm_sub_evictions = counter("ig_agent_subscriber_evictions_total",
                            "subscribers evicted after stalling past "
                            "their evict-after window")
_tm_attach_refused = counter("ig_agent_attach_refused_total",
                             "shared-run attach admissions refused",
                             ("reason",))


def _validate_sub_opts(opts: dict) -> str | None:
    """Server-side guard on subscriber options: an unknown policy or
    class must refuse the attach loudly, never default silently."""
    policy = opts.get("drop_policy") or "drop-oldest"
    if policy not in DROP_POLICIES:
        return f"unknown drop policy {policy!r} (want {DROP_POLICIES})"
    priority = opts.get("priority") or "normal"
    if priority not in PRIORITIES:
        return f"unknown priority class {priority!r} (want {PRIORITIES})"
    tier = opts.get("tier") or "full"
    if tier not in TIERS:
        return f"unknown delivery tier {tier!r} (want {TIERS})"
    try:
        if opts.get("queue") is not None and int(opts["queue"]) < 1:
            return f"subscriber queue bound must be >= 1, got {opts['queue']}"
        if opts.get("evict_after") is not None and \
                float(opts["evict_after"]) <= 0:
            return f"evict_after must be > 0, got {opts['evict_after']}"
    except (TypeError, ValueError) as e:
        return f"bad subscriber option: {e}"
    return None


# kinds a summary-tier subscriber receives: harvest summaries, alert
# transitions, sealed-window announcements, and trailers/acks — never
# raw rows/batches or per-record logs. Cheap consumers ride one shared
# harvest without paying for the firehose.
_SUMMARY_KINDS = frozenset({
    wire.EV_SUMMARY, wire.EV_ALERT, wire.EV_WINDOW, wire.EV_RESULT,
    wire.EV_CONTROL_ACK, wire.EV_RESUME_ACK, wire.EV_DROP_NOTICE,
    wire.EV_ATTACH_ACK, wire.EV_QUERY,
})


def _append_past_bound(q: queue.Queue, item) -> None:
    """Put `item` on `q` even when it is full; never blocks. A trailer or
    the end-of-stream sentinel takes one slot past the subscriber's
    bound instead of evicting a record it has not accounted for."""
    with q.mutex:
        q.queue.append(item)
        q.unfinished_tasks += 1
        q.not_empty.notify()


class Subscriber:
    """One consumer of a SharedRun: own outbound seq counter, own
    bounded queue with a validated drop policy, own cursor into the
    run's shared replay ring.

    A slow subscriber drops ITS OWN records (accounted per drop in
    `ig_agent_subscriber_drops_total{run,policy,class}` and reported on
    the wire via EV_DROP_NOTICE) and never stalls the gadget or its
    peers; one stalled past `evict_after` is evicted with a labeled
    terminal record. All mutation happens under the owning SharedRun's
    lock.
    """

    def __init__(self, sub_id: str, run_id: str, gadget: str, *,
                 priority: str = "normal", policy: str = "drop-oldest",
                 queue_max: int = SUB_QUEUE,
                 evict_after: float = EVICT_AFTER, tier: str = "full",
                 stamp_ring: int = RESUME_RING):
        self.sub_id = sub_id
        self.run_id = run_id
        self.gadget = gadget
        self.priority = priority
        self.policy = policy
        self.queue_max = max(int(queue_max), 1)
        self.evict_after = float(evict_after)
        self.tier = tier
        self.seq = 0
        self.drops = 0                 # records this sub's queue dropped
        self._drops_unreported = 0     # not yet carried by a DROP_NOTICE
        self.evicted = False
        self.left = False              # permanently gone (stop/evict)
        self.done = False              # saw the end-of-stream sentinel
        self.attaches = 0
        self.cursor = 0                # highest ring index stamped
        self.stalled_since: float | None = None
        self.detached_since: float | None = None
        self._q: queue.Queue | None = None
        self._gen = 0
        # (seq, ring_index | None, encoded | None): the stamped tail for
        # resume replay — ring entries by index (re-encoded on demand),
        # sub-local control records (acks/notices) by encoded bytes
        self._stamps: collections.deque = collections.deque(
            maxlen=max(int(stamp_ring), 1))
        self._m_drops = _tm_sub_drops.labels(run=run_id, policy=policy,
                                             **{"class": priority})

    @property
    def attached(self) -> bool:
        return self._q is not None

    def wants(self, kind: int) -> bool:
        if self.tier != "summary":
            return True
        return (kind >> wire.EV_LOG_SHIFT) == 0 and kind in _SUMMARY_KINDS

    # delivery (run lock held) ------------------------------------------

    def deliver(self, index: int, kind: int, header: dict, payload: bytes,
                force: bool) -> None:
        if self.left or self.done:
            return
        if self._q is None:
            return  # detached: cursor lags, the shared ring keeps the tail
        if not self.wants(kind):
            self.cursor = index  # consumed by the tier filter, no seq
            return
        self.cursor = index
        self.seq += 1
        msg = wire.encode_msg({**header, "seq": self.seq, "type": kind},
                              payload)
        self._stamps.append((self.seq, index, None))
        self._put(msg, force)

    def deliver_local(self, kind: int, header: dict, payload: bytes = b"",
                      force: bool = False) -> None:
        """A sub-local control record (drop notice, eviction trailer):
        seq-stamped like everything else so client accounting stays
        exact, retained encoded for resume replay."""
        if self.done:
            return
        self.seq += 1
        msg = wire.encode_msg({**header, "seq": self.seq, "type": kind},
                              payload)
        self._stamps.append((self.seq, None, msg))
        self._put(msg, force)

    def _put(self, msg: bytes, force: bool) -> None:
        q = self._q
        if q is None:
            return
        if force:
            # trailers (a result, the drop accounting, an eviction notice)
            # go in past the bound: evicting a queued record to fit one
            # would drop a record that the counts it carries have not
            # counted (the reference evicts here, and its clients then see
            # more seq gaps than drops)
            if q.full() and self.stalled_since is None:
                self.stalled_since = time.monotonic()
            _append_past_bound(q, msg)
            return
        try:
            q.put_nowait(msg)
            # hysteresis: a consumer is un-stalled when its queue has
            # genuinely drained, not when one slow read opened one slot
            # (that would reset the evict clock on every trickle)
            if self.stalled_since is not None \
                    and q.qsize() <= self.queue_max // 2:
                self.stalled_since = None
            return
        except queue.Full:
            if self.stalled_since is None:
                self.stalled_since = time.monotonic()
            if self.policy == "drop-newest":
                # the new record is the casualty; the client sees a seq
                # gap and the next DROP_NOTICE carries the count
                self._record_drop()
                return
            # drop-oldest: evict queued records until the new one fits
            while True:
                try:
                    q.put_nowait(msg)
                    return
                except queue.Full:
                    try:
                        q.get_nowait()
                        self._record_drop()
                    except queue.Empty:
                        pass

    def _record_drop(self) -> None:
        self.drops += 1
        self._drops_unreported += 1
        self._m_drops.inc()

    def maybe_notice(self, node: str) -> None:
        """Lazily report accumulated drops once the queue has room again
        (run lock held): the notice itself must not thrash a full
        queue."""
        q = self._q
        if (self._drops_unreported <= 0 or q is None
                or q.qsize() >= self.queue_max - 1):
            return
        dropped, self._drops_unreported = self._drops_unreported, 0
        self.deliver_local(wire.EV_DROP_NOTICE, {
            "node": node, "sub_id": self.sub_id, "dropped": dropped,
            "drops_total": self.drops, "policy": self.policy,
            "class": self.priority})

    # attach plumbing (run lock held) -----------------------------------

    def attach_queue(self, replay: list[bytes], done: bool
                     ) -> tuple[queue.Queue, int]:
        q: queue.Queue = queue.Queue(
            maxsize=self.queue_max + len(replay) + 8)
        for m in replay:
            q.put_nowait(m)
        if done:
            q.put_nowait(None)
        self._q = q
        self._gen += 1
        self.attaches += 1
        self.stalled_since = None
        self.detached_since = None
        return q, self._gen

    def owns_locked(self, gen: int) -> bool:
        return self._gen == gen and self._q is not None

    def sentinel(self) -> None:
        """End-of-stream for this subscriber; never blocks, and never
        evicts a record (it goes in past the bound, as a trailer does)."""
        self.done = True
        q = self._q
        if q is None:
            return
        _append_past_bound(q, None)

    def row(self, now: float) -> dict:
        q = self._q
        return {
            "sub_id": self.sub_id, "priority": self.priority,
            "policy": self.policy, "tier": self.tier, "seq": self.seq,
            "drops": self.drops, "attached": self.attached,
            "attaches": self.attaches, "evicted": self.evicted,
            "left": self.left, "queue_depth": q.qsize() if q else 0,
            "queue_max": self.queue_max,
            "stalled_for": (round(now - self.stalled_since, 3)
                            if self.stalled_since is not None else 0.0),
        }


class SharedRun:
    """Per-run outbound state shared by N subscribers, outliving any
    single RPC (the PR-8 RunStream grown into a first-class shared
    resource).

    Every outbound message gets a run-level ring index and lands in ONE
    bounded replay ring; each attached subscriber stamps its OWN seq and
    gets the message on its OWN bounded queue (drop policy + priority
    class + evict-after — a slow consumer can only hurt itself). A
    disconnected subscriber detaches (the ring keeps the tail at its
    cursor) and resumes with `resume {run_id, last_seq[, sub_id]}` —
    replaying its stamped-but-lost tail with the ORIGINAL seqs, then
    catching up from the shared ring with fresh seqs: no duplicates by
    construction, ring overflow reported as `missed` (healed upstream by
    sealed-window backfill). When the last attached subscriber detaches
    the gadget keeps running for `keepalive` seconds awaiting a
    (re-)attach, so dashboard churn doesn't thrash capture setup;
    non-resumable, non-shared runs keep the original cancel-on-
    disconnect contract exactly.
    """

    def __init__(self, run_id: str, gadget: str, *, resumable: bool = False,
                 linger: float = RESUME_LINGER, ring_size: int = RESUME_RING,
                 shared: bool = False, share_key: str = "",
                 keepalive: float | None = None,
                 max_subscribers: int = MAX_SUBSCRIBERS,
                 sub_budget: int = SUB_BUDGET,
                 node: str = ""):
        self.run_id = run_id
        self.gadget = gadget
        self.node = node
        self.resumable = bool(resumable)
        self.shared = bool(shared)
        self.share_key = share_key
        self.linger = float(linger)
        # last detach starts this countdown before the gadget actually
        # stops (defaults to the resume linger for PR-8 compatibility)
        self.keepalive = float(keepalive if keepalive is not None
                               else linger)
        self.max_subscribers = max(int(max_subscribers), 1)
        self.sub_budget = max(int(sub_budget), 1)
        self._ring_size = max(int(ring_size), 1)
        self._mu = threading.Lock()
        # (index, kind, header, payload) — raw, encoded per subscriber
        self._ring: collections.deque = collections.deque(
            maxlen=self._ring_size)
        self.index = 0
        self._subs: dict[str, Subscriber] = {}
        self._order: list[str] = []     # attach order; [0] is primary
        self._next_sub = 0
        self.done = False
        self.detached_at: float | None = None
        self.attaches = 0
        self._keepalive_timer: threading.Timer | None = None
        self.ctx = None  # the run's GadgetContext, set before first push
        self._m_msgs = _tm_stream_msgs.labels(gadget=gadget)
        self._m_dropped = _tm_stream_dropped.labels(gadget=gadget)
        self._m_qdepth = _tm_stream_q.labels(gadget=gadget)
        self._m_subs = _tm_run_subs.labels(run=run_id)

    # -- introspection ------------------------------------------------------

    def is_attached(self) -> bool:
        with self._mu:
            return any(s.attached for s in self._subs.values())

    def owns(self, sub: Subscriber, gen: int) -> bool:
        with self._mu:
            return sub.owns_locked(gen)

    @property
    def seq(self) -> int:
        """Highest subscriber seq (DumpState/debug view; per-subscriber
        seqs are the wire truth)."""
        with self._mu:
            return max((s.seq for s in self._subs.values()), default=0)

    @property
    def dropped(self) -> int:
        with self._mu:
            return sum(s.drops for s in self._subs.values())

    def live_subscribers(self) -> int:
        with self._mu:
            return self._live_count_locked()

    def _live_count_locked(self) -> int:
        return sum(1 for s in self._subs.values() if not s.left)

    # -- admission ----------------------------------------------------------

    def admit(self, opts: dict) -> Subscriber | dict:
        """Admission-control a new subscriber; returns the Subscriber or
        a typed refusal dict {refused, reason, detail}. Low-priority
        admissions are refused first as the run nears its budget."""
        bad = _validate_sub_opts(opts)
        if bad is not None:
            _tm_attach_refused.labels(reason="bad-options").inc()
            return {"refused": True, "reason": "bad-options", "detail": bad}
        priority = opts.get("priority") or "normal"
        queue_max = int(opts.get("queue") or SUB_QUEUE)
        with self._mu:
            # expired ghosts must not crowd out live admissions; any
            # cancel-context the expiry returns is deliberately ignored
            # — a subscriber is being admitted right now, so the run
            # must keep living regardless of the ghosts' departure
            self._expire_stale_locked(time.monotonic())
            if self.done:
                _tm_attach_refused.labels(reason="run-done").inc()
                return {"refused": True, "reason": "run-done",
                        "detail": f"run {self.run_id} already ended"}
            if self._live_count_locked() >= self.max_subscribers:
                _tm_attach_refused.labels(reason="max-subscribers").inc()
                return {"refused": True, "reason": "max-subscribers",
                        "detail": f"run {self.run_id} already serves "
                                  f"{self.max_subscribers} subscriber(s)"}
            usage = sum(s.queue_max for s in self._subs.values()
                        if not s.left)
            headroom = ADMIT_HEADROOM.get(priority, 1.0)
            if usage + queue_max > self.sub_budget * headroom:
                _tm_attach_refused.labels(reason="memory-budget").inc()
                return {"refused": True, "reason": "memory-budget",
                        "detail": f"{priority} admission would put queued "
                                  f"capacity at {usage + queue_max} > "
                                  f"{headroom:.0%} of budget "
                                  f"{self.sub_budget}"}
            sub_id = str(opts.get("id") or "")
            if not sub_id or sub_id in self._subs:
                self._next_sub += 1
                sub_id = f"s{self._next_sub}"
            sub = Subscriber(
                sub_id, self.run_id, self.gadget, priority=priority,
                policy=opts.get("drop_policy") or "drop-oldest",
                queue_max=queue_max,
                evict_after=float(opts.get("evict_after") or EVICT_AFTER),
                tier=opts.get("tier") or "full",
                stamp_ring=self._ring_size)
            sub.cursor = self.index  # joins live; history via attach()
            self._subs[sub_id] = sub
            self._order.append(sub_id)
            self._m_subs.set(self._live_count_locked())
            return sub

    # -- delivery -----------------------------------------------------------

    def push(self, kind: int, header: dict, payload: bytes = b"",
             force: bool = False) -> None:
        """Retain one raw copy in the shared ring, fan out to every
        subscriber under its own seq/queue/policy. `force` (trailers:
        EV_RESULT / EV_CONTROL_ACK) puts the trailer past a full queue's
        bound — a full queue must not eat the result."""
        evict: list[Subscriber] = []
        with self._mu:
            self.index += 1
            self._ring.append((self.index, kind, dict(header), payload))
            self._m_msgs.inc()
            now = time.monotonic()
            depth = 0
            for sub in self._subs.values():
                before = sub.drops
                sub.deliver(self.index, kind, header, payload, force)
                if sub.drops > before:
                    self._m_dropped.inc(sub.drops - before)
                sub.maybe_notice(self.node)
                if sub._q is not None:
                    depth = max(depth, sub._q.qsize())
                if (sub.attached and not sub.left
                        and sub.stalled_since is not None
                        and now - sub.stalled_since > sub.evict_after):
                    evict.append(sub)
            self._m_qdepth.set(depth)
            stale_ctx = self._expire_stale_locked(now)
        if stale_ctx is not None:
            stale_ctx.cancel()
        for sub in evict:
            self.evict(sub, f"stalled > {sub.evict_after:g}s "
                            f"(queue full, client not draining)")

    def evict(self, sub: Subscriber, why: str) -> None:
        """A wedged subscriber gets a labeled terminal record and its
        stream ends; the gadget and its peers never notice."""
        with self._mu:
            if sub.left or sub.done:
                return
            sub.evicted = True
            sub.deliver_local(wire.EV_DROP_NOTICE, {
                "node": self.node, "sub_id": sub.sub_id, "evicted": True,
                "reason": why, "dropped": sub._drops_unreported,
                "drops_total": sub.drops, "policy": sub.policy,
                "class": sub.priority}, force=True)
            sub._drops_unreported = 0
            _tm_sub_evictions.inc()
        log.warning("run %s (%s): evicting subscriber %s (%s, %s): %s",
                    self.run_id, self.gadget, sub.sub_id, sub.priority,
                    sub.policy, why)
        self.leave(sub)

    # -- attach / detach / leave --------------------------------------------

    def attach_subscriber(self, sub: Subscriber, last_seq: int
                          ) -> tuple[queue.Queue, int, dict]:
        """(Re-)attach a subscriber that holds everything up to
        last_seq. Replays its stamped-but-lost tail with the ORIGINAL
        seqs, then catches up from the shared ring (fresh seqs); what
        fell off either ring is `missed` — no duplicates, no silent
        holes."""
        with self._mu:
            self._cancel_keepalive_locked()
            if self.detached_at is not None:
                _tm_detached_runs.dec()
                self.detached_at = None
            self.attaches += 1
            ring_by_index = {i: (k, h, p) for i, k, h, p in self._ring}
            replay: list[bytes] = []
            missed = 0
            # 1) stamped tail the client lost in transit
            stamped = [t for t in sub._stamps if t[0] > last_seq]
            if stamped:
                missed += max(0, stamped[0][0] - last_seq - 1)
            elif sub.seq > last_seq:
                missed += sub.seq - last_seq
            for s, idx, enc in stamped:
                if enc is not None:
                    replay.append(enc)
                elif idx in ring_by_index:
                    k, h, p = ring_by_index[idx]
                    replay.append(wire.encode_msg(
                        {**h, "seq": s, "type": k}, p))
                else:
                    missed += 1
            replayed = len(replay)
            # 2) catch-up: ring entries past this sub's cursor, stamped
            # fresh now (entries that already fell off are missed)
            if self._ring:
                first = self._ring[0][0]
                if first > sub.cursor + 1:
                    missed += first - sub.cursor - 1
                for i, k, h, p in self._ring:
                    if i <= sub.cursor or not sub.wants(k):
                        if i > sub.cursor:
                            sub.cursor = i
                        continue
                    sub.cursor = i
                    sub.seq += 1
                    replay.append(wire.encode_msg(
                        {**h, "seq": sub.seq, "type": k}, p))
                    sub._stamps.append((sub.seq, i, None))
                    replayed += 1
            elif self.index > sub.cursor:
                missed += self.index - sub.cursor
                sub.cursor = self.index
            q, gen = sub.attach_queue(replay, self.done)
            self._m_subs.set(self._live_count_locked())
            ack = {"run_id": self.run_id, "sub_id": sub.sub_id,
                   "last_seq": int(last_seq), "missed": int(missed),
                   "replayed": replayed, "seq": sub.seq,
                   "attach": sub.attaches,
                   "subscribers": self._live_count_locked(),
                   "shared": self.shared}
            return q, gen, ack

    def resume(self, sub_id: str, last_seq: int
               ) -> tuple[Subscriber, queue.Queue, int, dict] | None:
        """Resolve the subscriber a `resume` first-message addresses: by
        sub_id when given (the supervisor echoes the acked id); without
        one (PR-8 wire compat — resumes carried no subscriber identity)
        prefer a DETACHED live subscriber — a resume is by definition a
        reconnect, and picking an attached peer would hijack its
        stream. Returns None when nothing matches (answered upstream as
        unknown_run so the client restarts fresh, exactly the PR-8
        linger-expiry contract)."""
        with self._mu:
            sub = None
            if sub_id:
                sub = self._subs.get(sub_id)
            else:
                live = [self._subs[sid] for sid in self._order
                        if sid in self._subs
                        and not self._subs[sid].left]
                detached = [s for s in live if not s.attached]
                if detached:
                    sub = detached[0]
                elif live:
                    sub = live[0]
            if sub is None or sub.left:
                return None
        q, gen, ack = self.attach_subscriber(sub, last_seq)
        return sub, q, gen, ack

    def detach(self, sub: Subscriber, gen: int) -> None:
        """A serving RPC ended. Only the subscriber's CURRENT attachment
        detaches (a generator superseded by a newer resume is a no-op).
        Resumable/shared runs start the keepalive countdown when the
        LAST attached subscriber detaches; everything else keeps the old
        cancel-on-disconnect contract."""
        ctx = None
        with self._mu:
            if not sub.owns_locked(gen):
                return
            sub._q = None
            sub.stalled_since = None
            sub.detached_since = time.monotonic()
            if self.done:
                return
            if any(s.attached and not s.left
                   for s in self._subs.values()):
                return  # peers still live: nothing run-level to do
            if self.detached_at is None:
                # leave() may have marked the run detached already while
                # this subscriber's generator was still draining its
                # sentinel — one detachment, one gauge increment
                self.detached_at = time.monotonic()
                _tm_detached_runs.inc()
            if (self.resumable or self.shared) and self.keepalive > 0:
                self._arm_keepalive_locked()
                return
            ctx = self.ctx
        if ctx is not None:
            ctx.cancel()

    def leave(self, sub: Subscriber) -> None:
        """A subscriber is gone for good (stop request, eviction, or
        resume-window expiry): it stops receiving, its queue drains to
        the sentinel, and when the last live subscriber leaves the
        keepalive countdown (not an immediate stop) decides the gadget's
        fate."""
        with self._mu:
            ctx = self._leave_locked(sub)
        if ctx is not None:
            ctx.cancel()

    def _leave_locked(self, sub: Subscriber):
        """Core of leave(); returns a context to cancel AFTER the lock
        is released (or None)."""
        if sub.left:
            return None
        sub.left = True
        sub.sentinel()
        self._m_subs.set(self._live_count_locked())
        if self.done or self._live_count_locked() > 0:
            return None
        if self.detached_at is None:
            self.detached_at = time.monotonic()
            _tm_detached_runs.inc()
        if (self.resumable or self.shared) and self.keepalive > 0:
            self._arm_keepalive_locked()
            return None
        return self.ctx

    def _expire_stale_locked(self, now: float):
        """A subscriber detached longer than the resume window (the
        run's `linger`) is gone for good: without this, crash-
        disconnected dashboards would hold max-subscribers slots and
        budget capacity for the life of the run. Returns a context to
        cancel after the lock is released (or None)."""
        ctx = None
        for sub in self._subs.values():
            if (not sub.left and not sub.attached
                    and sub.detached_since is not None
                    and now - sub.detached_since > max(self.linger, 0.0)):
                log.info("run %s (%s): subscriber %s expired after %.1fs "
                         "detached with no resume", self.run_id,
                         self.gadget, sub.sub_id, now - sub.detached_since)
                ctx = self._leave_locked(sub) or ctx
        return ctx

    def _arm_keepalive_locked(self) -> None:
        self._cancel_keepalive_locked()
        t = threading.Timer(self.keepalive, self._keepalive_expired)
        t.daemon = True
        self._keepalive_timer = t
        t.start()

    def _cancel_keepalive_locked(self) -> None:
        if self._keepalive_timer is not None:
            self._keepalive_timer.cancel()
            self._keepalive_timer = None

    def _keepalive_expired(self) -> None:
        with self._mu:
            # a LEFT subscriber still draining its sentinel is not a
            # reason to keep the gadget alive — only live attachments
            if self.done or any(s.attached and not s.left
                                for s in self._subs.values()):
                return
            # cancel UNDER the lock: an attach landing right now holds
            # the same lock, so it either lands before this check (we
            # return) or after the cancel (and sees the run wind down
            # with its trailer) — never a cancelled-under-the-client
            # limbo
            if self.ctx is not None:
                self.ctx.cancel()
        log.info("run %s (%s): no (re-)attach within %.1fs keepalive, "
                 "cancelling", self.run_id, self.gadget, self.keepalive)

    def keepalive_remaining(self) -> float:
        """Seconds until the lingering run cancels itself (0 when a
        client is attached or the run ended)."""
        with self._mu:
            if self.done or self.detached_at is None \
                    or self._keepalive_timer is None:
                return 0.0
            return max(
                0.0, self.keepalive - (time.monotonic() - self.detached_at))

    def finish(self) -> None:
        """The run ended: wake every attached subscriber with the
        end-of-stream sentinel (never blocking — a gone client must not
        leak the run thread)."""
        with self._mu:
            self.done = True
            self._cancel_keepalive_locked()
            if self.detached_at is not None:
                _tm_detached_runs.dec()
                self.detached_at = None
            for sub in self._subs.values():
                sub.sentinel()
            self._m_subs.set(0)

    def subscriber_rows(self) -> list[dict]:
        now = time.monotonic()
        with self._mu:
            return [self._subs[sid].row(now) for sid in self._order
                    if sid in self._subs]


class AgentServer:
    def __init__(self, node_name: str = "node", device: str = "cuda"):
        self.node_name = node_name
        # resolved once: an agent asked for cuda without a card raises
        # here, before serve() binds anything — never a CPU fallback
        self.device = resolve_device(device)
        self.runtime = LocalRuntime(node_name=node_name)
        self._runs: dict[str, GadgetContext] = {}
        # run_id → SharedRun: the resume/shared plane's registry. Entries
        # retire a keepalive-window after the run ends so a client that
        # dropped right before completion can still re-attach for the
        # tail.
        self._streams: dict[str, SharedRun] = {}
        # share_key → run_id: the first RunGadget request for a (gadget,
        # resolved-params) key starts the gadget; compatible requests
        # attach to the SAME running pipeline as subscribers.
        self._shared: dict[str, str] = {}
        self._runs_mu = threading.Lock()
        # legacy CRD-path serving (ref: main.go:262-299 starts the Trace
        # controller inside the node daemon)
        from ..gadgets.trace_resource import TraceStore
        self.traces = TraceStore(node_name=node_name, device=self.device)
        self._ckpt_stop: threading.Event | None = None
        self.metrics_server = None  # set by serve(--metrics-addr)
        self.port = 0  # set by serve(): the port gRPC bound

    def start_checkpointer(self, directory: str,
                           interval: float = 30.0) -> None:
        """Periodic sketch-state checkpointing (role of pinned BPF maps
        surviving daemon restarts, pkg/gadgets/helpers.go:36): every live
        tpusketch bundle + scorer is host-offloaded to `directory` each
        interval; instances started after a restart merge it back in."""
        from ..operators import tpusketch
        tpusketch.set_checkpoint_dir(directory)
        self._ckpt_stop = threading.Event()
        stop = self._ckpt_stop

        def loop():
            while not stop.wait(interval):
                tpusketch.checkpoint_all()

        threading.Thread(target=loop, daemon=True,
                         name="sketch-checkpointer").start()

    def stop_checkpointer(self) -> None:
        if self._ckpt_stop is not None:
            self._ckpt_stop.set()
            self._ckpt_stop = None
            # final save: a clean SIGTERM must not drop the last interval's
            # counts for still-running gadget runs (their post_gadget_run
            # never fires — the stream threads die with the process)
            from ..operators import tpusketch
            tpusketch.checkpoint_all()

    # -- GadgetManager.GetCatalog ------------------------------------------

    def get_catalog(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="GetCatalog").inc()
        catalog = build_catalog()
        catalog["node"] = self.node_name
        return wire.encode_msg({"catalog": catalog})

    # -- GadgetManager.RunGadget (bidi stream) ------------------------------

    def run_gadget(self, request_iterator: Iterator[bytes], context) -> Iterator[bytes]:
        _tm_rpc.labels(method="RunGadget").inc()
        first = next(request_iterator)
        header, _ = wire.decode_msg(first)
        # server span per RPC, parented to the client's fan-out span when
        # the request carries a traceparent (one trace end to end).
        # ambient=False: this span stays open across yields, and gRPC may
        # resume the generator on a different worker thread — an ambient
        # contextvar set here could strand a dead span as that thread's
        # parent; children parent via ctx.extra explicitly instead
        with TRACER.span("agent/RunGadget", parent=wire.extract_span(header),
                         attrs={"node": self.node_name},
                         ambient=False) as rpc_span:
            if header.get("resume"):
                yield from self._resume_stream(header["resume"],
                                               request_iterator, context)
            elif header.get("attach"):
                yield from self._attach_stream(header["attach"],
                                               request_iterator, context)
            else:
                yield from self._run_gadget_traced(header, rpc_span,
                                                   request_iterator, context)

    def _resume_stream(self, resume: dict, request_iterator,
                       context) -> Iterator[bytes]:
        """Re-attach a reconnecting client to a still-running (or just-
        finished, still-lingering) gadget run: replay everything after
        last_seq from the ring, then continue live — capture never
        restarted. An unknown run_id (this agent was respawned, or the
        linger expired) answers with `unknown_run` so the client knows
        to restart fresh and heal the gap from sealed windows instead."""
        run_id = str(resume.get("run_id") or "")
        last_seq = int(resume.get("last_seq") or 0)
        sub_id = str(resume.get("sub_id") or "")
        with self._runs_mu:
            state = self._streams.get(run_id)
        if state is None:
            yield wire.encode_msg(
                {"error": f"unknown run {run_id!r} on {self.node_name}: "
                          f"nothing to resume",
                 "unknown_run": True, "node": self.node_name})
            return
        resolved = state.resume(sub_id, last_seq)
        if resolved is None:
            # the run lives but this subscriber is gone (left, evicted,
            # or expired): answer unknown_run — the PR-8 linger-expiry
            # contract — so the supervisor backfills and restarts fresh
            # (a share=true restart re-attaches as a NEW subscriber)
            yield wire.encode_msg(
                {"error": f"subscriber {sub_id or '<primary>'!r} no longer "
                          f"exists on run {run_id!r} on {self.node_name}: "
                          f"nothing to resume",
                 "unknown_run": True, "node": self.node_name})
            return
        sub, q, gen, ack = resolved
        _tm_stream_resumes.labels(gadget=state.gadget).inc()
        log.info("run %s (%s): subscriber %s re-attached at seq %d "
                 "(replayed %d, missed %d)", run_id, state.gadget,
                 sub.sub_id, last_seq, ack["replayed"], ack["missed"])
        yield wire.encode_msg({"type": wire.EV_RESUME_ACK,
                               "node": self.node_name, "resume": ack})
        threading.Thread(target=self._control_loop,
                         args=(request_iterator, state.ctx, state, sub),
                         daemon=True).start()
        try:
            yield from self._serve_attached(state, sub, q, gen, context)
        finally:
            state.detach(sub, gen)

    def _attach_stream(self, attach: dict, request_iterator,
                       context) -> Iterator[bytes]:
        """Attach a NEW subscriber to an already-running shared gadget,
        by run_id or by share key: admission-controlled (max-subscribers
        + per-run subscriber budget, low priority refused first), ACKed
        (or refused) with a typed EV_ATTACH_ACK. The subscriber rides
        its own seq space/queue/policy from the moment of admission."""
        run_id = str(attach.get("run_id") or "")
        key = str(attach.get("key") or "")
        with self._runs_mu:
            if not run_id and key:
                run_id = self._shared.get(key, "")
            state = self._streams.get(run_id) if run_id else None
        if state is None or state.done:
            yield wire.encode_msg(
                {"error": f"unknown run {run_id or key!r} on "
                          f"{self.node_name}: nothing to attach to",
                 "unknown_run": True, "node": self.node_name})
            return
        admitted = state.admit(attach)
        if isinstance(admitted, dict):  # typed refusal
            yield wire.encode_msg(
                {"type": wire.EV_ATTACH_ACK, "node": self.node_name,
                 "attach": {**admitted, "run_id": state.run_id},
                 "error": f"attach refused ({admitted['reason']}): "
                          f"{admitted['detail']}"})
            return
        sub = admitted
        q, gen, ack = state.attach_subscriber(sub, int(attach.get(
            "last_seq") or 0))
        log.info("run %s (%s): subscriber %s attached (%s, %s, tier=%s; "
                 "%d live)", state.run_id, state.gadget, sub.sub_id,
                 sub.priority, sub.policy, sub.tier, ack["subscribers"])
        yield wire.encode_msg({"type": wire.EV_ATTACH_ACK,
                               "node": self.node_name, "attach": ack})
        threading.Thread(target=self._control_loop,
                         args=(request_iterator, state.ctx, state, sub),
                         daemon=True).start()
        try:
            yield from self._serve_attached(state, sub, q, gen, context)
        finally:
            state.detach(sub, gen)

    @staticmethod
    def _control_loop(request_iterator, ctx, state, sub=None) -> None:
        """Client stop requests: on a SHARED run a subscriber's stop
        detaches that subscriber (last one out starts the keepalive
        countdown, the gadget never thrashes on dashboard churn); on a
        private run it cancels the gadget as before. `{"stop": "run"}`
        force-cancels a shared gadget. Transport death is NOT a stop for
        resumable/shared runs — the serving loop's detach starts the
        keepalive window instead; non-resumable runs keep the original
        cancel-on-disconnect contract."""
        try:
            for msg in request_iterator:
                h, _ = wire.decode_msg(msg)
                if h.get("stop"):
                    if (state is not None and state.shared
                            and sub is not None
                            and h.get("stop") != "run"):
                        state.leave(sub)
                    elif ctx is not None:
                        ctx.cancel()
                    return
        except Exception:  # noqa: BLE001 — iterator died with the client
            if (state is None or not (state.resumable or state.shared)) \
                    and ctx is not None:
                ctx.cancel()

    def _serve_attached(self, state: SharedRun, sub: Subscriber,
                        q: queue.Queue, gen: int,
                        context) -> Iterator[bytes]:
        """Pump one subscriber attachment's queue onto the wire until
        end-of-run, client death, eviction, or takeover by a newer
        resume attachment."""
        while True:
            try:
                item = q.get(timeout=0.25)
            except queue.Empty:
                if not context.is_active():
                    return
                if not state.owns(sub, gen):
                    return  # a newer resume took the stream over
                continue
            if item is None:
                return
            yield item
            if not context.is_active():
                return

    def _retire_stream(self, state: SharedRun, after: float) -> None:
        def retire():
            with self._runs_mu:
                # identity-guarded: an unknown-run restart may have
                # re-registered the same run_id with a NEW stream state
                if self._streams.get(state.run_id) is state:
                    self._streams.pop(state.run_id, None)
                if state.share_key and \
                        self._shared.get(state.share_key) == state.run_id:
                    self._shared.pop(state.share_key, None)
        t = threading.Timer(max(after, 0.5), retire)
        t.daemon = True
        t.start()

    @staticmethod
    def share_key(run: dict) -> str:
        """The shared-run identity: gadget + resolved flat params +
        requested outputs. Two requests with the same key drive the SAME
        capture/sketch pipeline; anything that would change what the
        gadget computes or emits forks the key."""
        return json.dumps([
            run.get("category", ""), run.get("name", ""),
            sorted((run.get("params") or {}).items()),
            sorted(set(run.get("output") or ["json"])),
        ], separators=(",", ":"))

    def _run_gadget_traced(self, header: dict, rpc_span, request_iterator,
                           context) -> Iterator[bytes]:
        run = header.get("run")
        if not run:
            yield wire.encode_msg({"error": "first message must be a run request"})
            return

        sub_opts = dict(run.get("subscriber") or {})
        bad = _validate_sub_opts(sub_opts)
        if bad is not None:
            yield wire.encode_msg({"error": bad})
            return

        if run.get("share"):
            key = self.share_key(run)
            with self._runs_mu:
                existing = self._streams.get(self._shared.get(key, ""))
            if existing is not None and not existing.done:
                # the gadget is already running for this exact request:
                # attach as a subscriber instead of paying for a second
                # capture + sketch + history pipeline
                yield from self._attach_stream(
                    {**sub_opts, "run_id": existing.run_id},
                    request_iterator, context)
                return

        try:
            desc = gadget_registry.get(run["category"], run["name"])
        except KeyError as e:
            yield wire.encode_msg({"error": str(e)})
            return

        flat = run.get("params", {})
        gadget_params = desc.params().to_params()
        gadget_params.copy_from_map(flat, "gadget.")
        op_params = Collection({
            f"operator.{op.name}.": op.instance_params().to_params()
            for op in op_registry.get_all() if op.can_operate_on(desc)
        })
        op_params.copy_from_map(flat)

        outputs = set(run.get("output") or ["json"])
        ctx = GadgetContext(
            desc, gadget_params=gadget_params, operator_params=op_params,
            timeout=float(run.get("timeout") or 0),
            run_id=run.get("run_id") or None,
            device=self.device,
        )
        # run-with-result gadgets render server-side in the requested format
        ctx.extra["output"] = "json" if "result-json" in outputs else "columns"
        # per-RUN logger (child of the shared gadget logger, so records
        # still propagate to it and the flight recorder): the stream log
        # handler below must only see THIS run's records — attaching to
        # the shared logger would cross-stream concurrent runs' logs and,
        # with an in-process client, echo received lines back out forever.
        # Constructed directly, NOT via getLogger: the manager caches
        # named loggers forever, and one per run would leak unbounded in
        # a long-lived agent.
        run_logger = logging.Logger(f"ig-tpu.{desc.full_name}.{ctx.run_id}")
        run_logger.parent = logging.getLogger(f"ig-tpu.{desc.full_name}")
        ctx.logger = run_logger
        # resume/shared plane: the client opts in per run; the stream
        # state below outlives this RPC so a reconnect can re-attach and
        # later compatible requests can subscribe
        share_key = self.share_key(run) if run.get("share") else ""
        state = SharedRun(
            ctx.run_id, desc.full_name,
            resumable=bool(run.get("resumable")),
            linger=float(run.get("linger") or RESUME_LINGER),
            ring_size=int(run.get("ring") or RESUME_RING),
            shared=bool(run.get("share")),
            share_key=share_key,
            keepalive=(float(run["keepalive"])
                       if run.get("keepalive") is not None else None),
            max_subscribers=int(run.get("max_subscribers")
                                or MAX_SUBSCRIBERS),
            sub_budget=int(run.get("sub_budget") or SUB_BUDGET),
            node=self.node_name)
        state.ctx = ctx
        primary = state.admit(sub_opts)
        if isinstance(primary, dict):  # refusal on the FIRST subscriber
            yield wire.encode_msg(
                {"type": wire.EV_ATTACH_ACK, "node": self.node_name,
                 "attach": {**primary, "run_id": ctx.run_id},
                 "error": f"attach refused ({primary['reason']}): "
                          f"{primary['detail']}"})
            return
        prev = None
        lost_to = ""
        with self._runs_mu:
            if share_key:
                # the AUTHORITATIVE share-key decision happens here,
                # under the registry lock: the early pre-ctx check is an
                # optimization, and two concurrent first-requests for
                # one key must not both start gadgets — first to
                # register wins, the loser attaches to it instead
                winner = self._streams.get(self._shared.get(share_key, ""))
                if winner is not None and not winner.done:
                    lost_to = winner.run_id
                else:
                    self._shared[share_key] = ctx.run_id
            if not lost_to:
                prev = self._streams.get(ctx.run_id)
                self._runs[ctx.run_id] = ctx
                self._streams[ctx.run_id] = state
        if lost_to:
            log.info("run %s (%s): lost the share-key race to %s; "
                     "attaching as a subscriber instead of starting a "
                     "second gadget", ctx.run_id, desc.full_name, lost_to)
            yield from self._attach_stream(
                {**sub_opts, "run_id": lost_to}, request_iterator, context)
            return
        if prev is not None and not prev.done and prev.ctx is not None:
            # a client restarting under a reused run_id while the
            # previous life still lingers: two gadgets capturing under
            # one id would double-count — the new request supersedes
            log.warning("run %s (%s): superseded by a new run request; "
                        "cancelling the previous life",
                        ctx.run_id, desc.full_name)
            prev.ctx.cancel()
        _tm_active_runs.inc()
        # server span per run (child of the RPC span); operators and the
        # device plane parent their spans to this via ctx.extra —
        # ambient=False for the same cross-thread-generator reason.
        # The run span, registries, and log handler are unwound by the
        # RUN thread when the gadget actually ends — NOT when this RPC's
        # generator dies, because a resumable run outlives its first
        # connection by design.
        run_span = TRACER.span(f"agent/run/{desc.full_name}",
                               parent=rpc_span.context,
                               attrs={"run_id": ctx.run_id,
                                      "gadget": desc.full_name},
                               ambient=False)
        yield from self._run_gadget_stream(ctx, desc, outputs, state,
                                           primary, run_span,
                                           request_iterator, context)

    def _run_gadget_stream(self, ctx, desc, outputs, state: SharedRun,
                           primary: Subscriber, run_span, request_iterator,
                           context) -> Iterator[bytes]:
        cleanup_mu = threading.Lock()
        cleanup_state = {"done": False, "handler": None}

        def run_cleanup():
            """Unwound exactly ONCE when the RUN ends (run thread,
            loud-failure path, or a setup crash) — never on a mere
            client disconnect: a resumable run outlives its first
            connection by design."""
            with cleanup_mu:
                if cleanup_state["done"]:
                    return
                cleanup_state["done"] = True
            ctx.cancel()
            if cleanup_state["handler"] is not None:
                ctx.logger.removeHandler(cleanup_state["handler"])
            with self._runs_mu:
                # identity-guarded: a superseding run request may have
                # re-registered this run_id with a NEW context/stream
                if self._runs.get(ctx.run_id) is ctx:
                    self._runs.pop(ctx.run_id, None)
            _tm_active_runs.dec()
            run_span.__exit__(None, None, None)
            # keep the stream state around one linger/keepalive window so
            # a client that dropped right before the end can resume for
            # the tail
            self._retire_stream(state, max(state.linger, state.keepalive))

        try:
            yield from self._run_stream_setup_and_serve(
                ctx, desc, outputs, state, primary, run_span, run_cleanup,
                cleanup_state, request_iterator, context)
        except GeneratorExit:
            # client disconnect mid-serve: the serving finally already
            # detached; the run itself lives on (or cancels via detach
            # for non-resumable runs) — no registry unwind here
            raise
        except BaseException:
            # setup (or serving) died before the run thread could take
            # ownership of cleanup: unwind so _runs/_streams and the
            # active-runs gauge cannot drift in a long-lived agent
            run_cleanup()
            state.finish()
            raise

    def _run_stream_setup_and_serve(self, ctx, desc, outputs,
                                    state: SharedRun, primary: Subscriber,
                                    run_span, run_cleanup, cleanup_state,
                                    request_iterator,
                                    context) -> Iterator[bytes]:
        push = state.push

        # run logs multiplex onto the same stream with severity in the
        # type bits; run/trace IDs ride the header so the client can
        # correlate a remote log line with this run's spans
        run_span.__enter__()
        ctx.extra["trace_ctx"] = run_span.context
        trace_ctx = ctx.extra.get("trace_ctx")
        stream_log = StreamLogger(
            push, shift=wire.EV_LOG_SHIFT, run_id=ctx.run_id,
            trace_id=trace_ctx.trace_id if trace_ctx is not None else "")
        log_handler = StreamLogHandler(stream_log)
        ctx.logger.addHandler(log_handler)
        cleanup_state["handler"] = log_handler

        cols = desc.columns()

        def row_dict(ev) -> dict:
            d = cols.to_dict(ev)
            d["node"] = self.node_name  # authoritative node identity
            return d

        def on_event(ev):
            if "json" in outputs:
                push(wire.EV_PAYLOAD_JSON, {"node": self.node_name},
                     json.dumps(row_dict(ev), default=str).encode())

        def on_event_array(evs):
            if "json" in outputs:
                payload = json.dumps(
                    [row_dict(e) for e in evs], default=str).encode()
                push(wire.EV_PAYLOAD_ARRAY, {"node": self.node_name}, payload)

        def on_batch(batch):
            if "batch" in outputs and batch.count:
                push(wire.EV_BATCH_NPZ, {"node": self.node_name,
                                         "drops": batch.drops},
                     wire.encode_batch(batch))

        if "summary" in outputs:
            def on_summary(summary):
                h, payload = wire.encode_summary(summary)
                push(wire.EV_SUMMARY, {"node": self.node_name, **h}, payload)
            ctx.extra["on_sketch_summary"] = on_summary

        # alert transitions ride the same stream as typed events whenever
        # the alerts operator is enabled for this run (rules set); the
        # client's GrpcRuntime folds them cluster-wide
        def on_alert_event(alert: dict):
            push(wire.EV_ALERT, {"node": self.node_name, "alert": alert})
        ctx.extra["on_alert_event"] = on_alert_event

        # sealed-window announcements ride the stream as header-only
        # EV_WINDOW records: summary-tier subscribers learn a window
        # exists (and can FetchWindows it) without the raw batches
        def on_window_sealed(win_header: dict):
            push(wire.EV_WINDOW, {"node": self.node_name,
                                  "window": win_header})
        ctx.extra["on_window_sealed"] = on_window_sealed

        # standing-query materialized answers ride the summary tier as
        # EV_QUERY records (header: query identity + coverage digest;
        # payload: one packed sealed window — the QueryWindows reply
        # frame shape, so subscribers reuse the same decode path)
        def on_query_answer(qheader: dict, qpayload: bytes):
            push(wire.EV_QUERY, {"node": self.node_name,
                                 "query": qheader}, qpayload)
        ctx.extra["on_query_answer"] = on_query_answer

        # control reader: client stop requests cancel the context (or
        # detach the subscriber on a shared run)
        threading.Thread(target=self._control_loop,
                         args=(request_iterator, ctx, state, primary),
                         daemon=True).start()

        # resolve handler wiring BEFORE spawning the run thread so an
        # unknown gadget type fails the RPC loudly instead of vanishing
        # inside a daemon thread
        try:
            h_event, h_array = handlers_for(desc.gadget_type, outputs,
                                            on_event, on_event_array)
        except ValueError as e:
            log.error("RunGadget %s: %s", desc.full_name, e)
            # the error trailer goes through the ring like every other
            # trailer: a client that loses this connection and resumes
            # within the retire window must still see the failure, not
            # a clean empty end
            push(wire.EV_RESULT, {"error": str(e), "gadget_error": True},
                 force=True)
            run_cleanup()
            state.finish()
            q, gen, _ack = state.attach_subscriber(primary, 0)
            try:
                yield from self._serve_attached(state, primary, q, gen,
                                                context)
            finally:
                state.detach(primary, gen)
            return
        if "json" not in outputs:
            # rows ride the stream only as json: without it a row handler
            # would decode every event of every batch into a row object
            # that nothing sends (the reference wires one all the same)
            h_event = h_array = None

        def run_thread():
            try:
                res = self.runtime.run_gadget(
                    ctx,
                    on_event=h_event,
                    on_event_array=h_array,
                    on_batch=on_batch,
                )
                # trailers ride the same seq'd push path (force=True: past
                # a full queue's bound, never dropped) — they live in the
                # ring too, so a resumed client still gets them
                node_res = res.get(self.node_name) if res else None
                if node_res is not None and node_res.error:
                    push(wire.EV_RESULT, {"error": node_res.error,
                                          "gadget_error": True}, force=True)
                elif node_res is not None and isinstance(node_res.result,
                                                         bytes):
                    push(wire.EV_RESULT, {}, node_res.result, force=True)
                if state.dropped:
                    push(wire.EV_CONTROL_ACK, {"dropped": state.dropped},
                         force=True)
            finally:
                run_cleanup()
                # end-of-stream sentinel; never blocks on a gone client
                state.finish()

        t = threading.Thread(target=run_thread, daemon=True)
        t.start()

        q, gen, _ack = state.attach_subscriber(primary, 0)
        try:
            yield from self._serve_attached(state, primary, q, gen, context)
        finally:
            state.detach(primary, gen)

    # -- ContainerManager (hook-facing; ref: gadgettracermanager.go:151) ----

    def add_container(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="AddContainer").inc()
        h, _ = wire.decode_msg(request)
        from ..operators.operators import ensure_initialized
        lm = ensure_initialized("localmanager")
        c = h.get("container", {})
        lm.cc.add_container(Container(
            id=c.get("id", ""), name=c.get("name", ""),
            pid=int(c.get("pid", 0)), mntns=int(c.get("mntns", 0)),
            netns=int(c.get("netns", 0)), namespace=c.get("namespace", ""),
            pod=c.get("pod", ""), labels=c.get("labels", {}),
        ))
        return wire.encode_msg({"ok": True, "count": len(lm.cc)})

    def remove_container(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="RemoveContainer").inc()
        h, _ = wire.decode_msg(request)
        from ..operators.operators import get as get_op
        lm = get_op("localmanager")
        if lm.cc is not None:
            lm.cc.remove_container(h.get("container", {}).get("id", ""))
        return wire.encode_msg({"ok": True})

    # -- Trace-resource RPCs (ref: §3.5 — the CRD path served remotely) -----

    def apply_trace(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="ApplyTrace").inc()
        h, _ = wire.decode_msg(request)
        try:
            return wire.encode_msg({"trace": self.traces.apply(h.get("trace", {}))})
        except Exception as e:
            return wire.encode_msg({"error": str(e)})

    def get_trace(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="GetTrace").inc()
        h, _ = wire.decode_msg(request)
        doc = self.traces.get(h.get("name", ""))
        if doc is None:
            return wire.encode_msg({"error": f"trace {h.get('name')!r} not found"})
        return wire.encode_msg({"trace": doc})

    def list_traces(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="ListTraces").inc()
        return wire.encode_msg({"traces": self.traces.list()})

    def delete_trace(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="DeleteTrace").inc()
        h, _ = wire.decode_msg(request)
        return wire.encode_msg({"deleted": self.traces.delete(h.get("name", ""))})

    # -- capture/recording lifecycle RPCs (capture/) ------------------------

    def start_recording(self, request: bytes, context) -> bytes:
        """Arm the node-wide recording: every running and future gadget
        run on this agent tees its batches/summaries/alerts into
        journals under the recording directory until StopRecording."""
        _tm_rpc.labels(method="StartRecording").inc()
        h, _ = wire.decode_msg(request)
        from ..capture import RECORDINGS
        opts = {k: v for k, v in (h.get("opts") or {}).items()
                if k in ("max_segment_bytes", "max_segment_age",
                         "retention_bytes", "retention_segments")}
        rid = h.get("recording_id", "")
        existing = RECORDINGS.get(rid) if rid else None
        if existing is not None:
            # idempotent for fan-out retries and in-process agent fleets
            # sharing one manager: arming an armed recording is a no-op
            return wire.encode_msg({"ok": True, "recording_id": existing.id,
                                    "dir": existing.path, "already": True,
                                    "node": self.node_name})
        try:
            # always the manager's base area (--capture-dir): a client-
            # chosen base would be invisible to ListRecordings/Fetch,
            # which resolve under the same default
            rec = RECORDINGS.start(rid, **opts)
        except (ValueError, OSError) as e:
            return wire.encode_msg({"error": str(e)})
        return wire.encode_msg({"ok": True, "recording_id": rec.id,
                                "dir": rec.path, "node": self.node_name})

    def stop_recording(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="StopRecording").inc()
        h, _ = wire.decode_msg(request)
        import os
        from ..capture import RECORDINGS
        from ..capture.manager import RECORDING_META
        rid = h.get("recording_id", "")
        try:
            meta = RECORDINGS.stop(rid)
        except KeyError as e:
            # a peer RPC in the same process (in-process fleet) may have
            # stopped it already: a sealed recording on disk is success,
            # a never-started id is the error
            try:
                done = os.path.join(RECORDINGS.recording_dir(rid),
                                    RECORDING_META)
            except ValueError as bad:
                return wire.encode_msg({"error": str(bad)})
            if rid and os.path.exists(done):
                return wire.encode_msg({"ok": True, "already": True,
                                        "node": self.node_name})
            return wire.encode_msg({"error": str(e)})
        return wire.encode_msg({"ok": True, "recording": meta,
                                "node": self.node_name})

    def list_recordings(self, request: bytes, context) -> bytes:
        """Active + on-disk recordings; with recording_id set, also the
        relative file list (the fetch fan-out's download manifest)."""
        _tm_rpc.labels(method="ListRecordings").inc()
        h, _ = wire.decode_msg(request)
        from ..capture import RECORDINGS
        msg: dict = {"node": self.node_name,
                     "recordings": RECORDINGS.list()}
        rid = h.get("recording_id", "")
        if rid:
            import os
            try:
                root = RECORDINGS.recording_dir(rid)
            except ValueError as e:
                msg["error"] = str(e)
                return wire.encode_msg(msg)
            files = []
            if os.path.isdir(root):
                for base, _dirs, names in os.walk(root):
                    for name in sorted(names):
                        p = os.path.join(base, name)
                        files.append({"path": os.path.relpath(p, root),
                                      "bytes": os.path.getsize(p)})
            else:
                msg["error"] = f"no recording {rid!r} on {self.node_name}"
            msg["files"] = sorted(files, key=lambda f: f["path"])
        return wire.encode_msg(msg)

    def fetch_segment(self, request: bytes, context) -> bytes:
        """Chunked download of one recording file (segments, manifests);
        stays under gRPC's 4 MiB default message cap via offset+limit."""
        _tm_rpc.labels(method="FetchSegment").inc()
        h, _ = wire.decode_msg(request)
        import os
        from ..capture import RECORDINGS
        rid = h.get("recording_id", "")
        rel = h.get("file", "")
        norm = os.path.normpath(rel)
        if not rid or not rel or norm.startswith("..") or \
                os.path.isabs(norm):
            return wire.encode_msg(
                {"error": f"bad fetch request ({rid!r}, {rel!r})"})
        try:
            path = os.path.join(RECORDINGS.recording_dir(rid), norm)
        except ValueError as e:
            return wire.encode_msg({"error": str(e)})
        offset = max(int(h.get("offset", 0)), 0)
        limit = min(max(int(h.get("limit", 1 << 20)), 1), 2 << 20)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read(limit)
        except OSError as e:
            return wire.encode_msg({"error": f"{rel}: {e.strerror or e}"})
        return wire.encode_msg(
            {"ok": True, "file": rel, "offset": offset, "size": size,
             "eof": offset + len(chunk) >= size}, chunk)

    # -- sketch-history RPCs (history/): range-listing + chunked pulls ------

    @staticmethod
    def _window_range(h: dict) -> dict:
        """The (optional) range/slice filter every history RPC accepts —
        one parse, shared by ListWindows and FetchWindows."""
        return {
            "start_ts": float(h["start_ts"]) if h.get("start_ts") is not None else None,
            "end_ts": float(h["end_ts"]) if h.get("end_ts") is not None else None,
            "start_seq": int(h["start_seq"]) if h.get("start_seq") is not None else None,
            "end_seq": int(h["end_seq"]) if h.get("end_seq") is not None else None,
            "key": h.get("key") or None,
        }

    def list_windows(self, request: bytes, context) -> bytes:
        """Header rows of every sealed window overlapping the requested
        seq/ts range (and slice key) — the pruning half of a fleet-wide
        range query: the client decides which windows are worth pulling
        before any payload bytes move."""
        _tm_rpc.labels(method="ListWindows").inc()
        h, _ = wire.decode_msg(request)
        from ..history import HISTORY, validate_store_name
        gadget = h.get("gadget", "") or ""
        if gadget:
            try:
                validate_store_name(gadget.replace("/", "-"))
            except ValueError as e:
                return wire.encode_msg({"error": str(e)})
        losses: list = []
        try:
            # node=self.node_name: an agent serves only windows ITS runs
            # sealed — in-process fleets share one base area, and a
            # fan-out merging every node's windows from every node would
            # double-count
            rows = HISTORY.list_windows(gadget=gadget, losses=losses,
                                        node=self.node_name,
                                        **self._window_range(h))
        except (OSError, ValueError) as e:
            return wire.encode_msg({"error": str(e)})
        return wire.encode_msg({"ok": True, "node": self.node_name,
                                "windows": rows, "losses": losses})

    def fetch_windows(self, request: bytes, context) -> bytes:
        """Chunked download of matching windows' frames; every reply
        stays under the gRPC message cap via offset + max_bytes (the
        FetchSegment discipline applied to typed windows instead of raw
        files). Store names resolve server-side only — the one
        client-supplied path component (gadget) is traversal-guarded."""
        _tm_rpc.labels(method="FetchWindows").inc()
        h, _ = wire.decode_msg(request)
        from ..history import HISTORY, pack_frames, validate_store_name
        gadget = h.get("gadget", "") or ""
        if gadget:
            try:
                validate_store_name(gadget.replace("/", "-"))
            except ValueError as e:
                return wire.encode_msg({"error": str(e)})
        try:
            # pagination contract: ANY offset is well-formed — one past
            # the last match (offset == N) or far beyond (offset > N)
            # returns an EMPTY ok reply with eof=true, never an error
            # (the client's drain loop lands on exactly N after a full
            # chunk, and a store shrunk by GC/compaction between chunks
            # can leave it beyond)
            offset = max(int(h.get("offset", 0)), 0)
            max_bytes = min(max(int(h.get("max_bytes", 1 << 20)), 1),
                            2 << 20)
        except (TypeError, ValueError) as e:
            return wire.encode_msg({"error": f"bad offset/max_bytes: {e}"})
        losses: list = []
        picked: list[tuple[dict, bytes]] = []
        size = 0
        eof = True
        try:
            it = HISTORY.fetch_windows(gadget=gadget, losses=losses,
                                       node=self.node_name,
                                       **self._window_range(h))
            for i, (header, payload) in enumerate(it):
                if i < offset:
                    continue
                frame_size = len(payload) + 512  # header slack
                if picked and size + frame_size > max_bytes:
                    eof = False
                    break
                picked.append((header, payload))
                size += frame_size
        except (OSError, ValueError) as e:
            return wire.encode_msg({"error": str(e)})
        return wire.encode_msg(
            {"ok": True, "node": self.node_name, "count": len(picked),
             "offset": offset, "next_offset": offset + len(picked),
             "eof": eof,
             # every chunk rescans from frame 0, so only the FIRST chunk
             # reports torn-tail losses — the client concatenates reply
             # losses, and repeating them would multiply the accounting
             "losses": losses if offset == 0 else []},
            pack_frames(picked))

    def query_windows(self, request: bytes, context) -> bytes:
        """Query pushdown (history/lifecycle plane): fold the
        (time-range, seq-range, key) query NODE-SIDE — prune, decode,
        dedupe across tiers, merge — and ship back ONE merged window
        plus accounting (windows folded, levels consulted, torn/dropped
        counts). Fleet-query wire cost becomes O(nodes) instead of
        O(windows): the raw windows never leave the node."""
        _tm_rpc.labels(method="QueryWindows").inc()
        h, _ = wire.decode_msg(request)
        from ..history import (HISTORY, decode_frames, dedupe_compacted,
                               encode_window, level_counts, merge_windows,
                               merged_to_sealed, pack_frames,
                               validate_store_name)
        gadget = h.get("gadget", "") or ""
        if gadget:
            try:
                validate_store_name(gadget.replace("/", "-"))
            except ValueError as e:
                return wire.encode_msg({"error": str(e)})
        losses: list = []
        try:
            frames = list(HISTORY.fetch_windows(
                gadget=gadget, losses=losses, node=self.node_name,
                **self._window_range(h)))
        except (OSError, ValueError) as e:
            return wire.encode_msg({"error": str(e)})
        kept, notes = dedupe_compacted(decode_frames(frames))
        merged = merge_windows(kept)
        levels = level_counts(kept)
        payload = b""
        if merged.windows:
            sw = merged_to_sealed(
                merged, gadget=gadget or kept[0].gadget,
                node=self.node_name, level=max(levels, default=0),
                window=0, run_id="query")
            payload = pack_frames([encode_window(sw)])
        return wire.encode_msg({
            "ok": True,
            "node": self.node_name,
            "folded": merged.windows,
            "levels": {str(k): v for k, v in sorted(levels.items())},
            "torn": len(losses),
            "dropped": list(merged.skipped) + notes,
            "losses": losses,
        }, payload)

    # -- dump-state debug RPC (ref: gadgettracermanager.go DumpState :204) --

    def dump_state(self, request: bytes, context) -> bytes:
        _tm_rpc.labels(method="DumpState").inc()
        try:
            req, _ = wire.decode_msg(request)
        except (ValueError, json.JSONDecodeError):
            req = {}
        import sys
        frames = {}
        for tid, frame in sys._current_frames().items():
            stack = []
            f = frame
            while f is not None and len(stack) < 32:
                stack.append(f"{f.f_code.co_filename}:{f.f_lineno} {f.f_code.co_name}")
                f = f.f_back
            frames[str(tid)] = stack
        with self._runs_mu:
            runs = list(self._runs)
            stream_states = list(self._streams.values())
        # resume/shared-plane view: every live (or lingering) run stream
        # with its attach + subscriber state — `ig-tpu fleet health` and
        # `ig-tpu fleet runs` read this to tell a serving run from one
        # awaiting a resume, and a saturated run from an idle one
        now = time.monotonic()
        run_rows = [{
            "run_id": st.run_id, "gadget": st.gadget, "seq": st.seq,
            "resumable": st.resumable, "attached": st.is_attached(),
            "attaches": st.attaches, "done": st.done,
            "dropped": st.dropped,
            "detached_for": (round(now - st.detached_at, 3)
                             if st.detached_at is not None else 0.0),
            "shared": st.shared,
            "subscribers": st.subscriber_rows(),
            "live_subscribers": st.live_subscribers(),
            "max_subscribers": st.max_subscribers,
            "sub_budget": st.sub_budget,
            "keepalive": st.keepalive,
            "keepalive_remaining": round(st.keepalive_remaining(), 3),
        } for st in stream_states]
        # container set, as the reference's DumpState does
        # (gadgettracermanager.go:204-219 dumps containers + stacks)
        containers: list = []
        dump_error = ""
        try:
            from ..operators.operators import get as get_op
            lm = get_op("localmanager")
            if lm.cc is not None:
                containers = [
                    {"id": c.id, "name": c.name, "pid": c.pid,
                     "mntns": c.mntns, "namespace": c.namespace, "pod": c.pod,
                     "runtime": c.runtime}
                    for c in lm.cc.get_all()
                ]
        except Exception as e:
            dump_error = f"container dump failed: {e!r}"
        # the node's history-tier footprint rides the debug dump too:
        # `ig-tpu history tiers --remote` and the doctor history_tiers
        # row read windows/bytes per compaction level + archive usage
        # without a store-walking RPC of their own
        history_tiers: dict = {}
        try:
            from ..history import HISTORY
            # TTL-cached: fleet health/runs/alerts all poll DumpState,
            # and the tier walk reads every store frame
            history_tiers = HISTORY.tier_stats(ttl=10.0)
        except Exception as e:  # noqa: BLE001 — debug dump stays best-effort
            history_tiers = {"error": repr(e)}
        # standing-query accounting rides the debug dump the same way:
        # one row per live query (coverage, refresh/publish counts,
        # cache hit/miss/invalidation) so `ig-tpu watch --table` and
        # `fleet queries` never need a store-walking RPC
        standing_queries: list = []
        try:
            from ..queries import live_stats
            standing_queries = live_stats()
        except Exception as e:  # noqa: BLE001 — debug dump stays best-effort
            standing_queries = [{"error": repr(e)}]
        # pipeline health (ISSUE 18): one row per live run — per-stage
        # lag watermarks/quantiles, starved ratio, backpressure — so
        # `ig-tpu fleet lag` and the doctor pipeline_health row read the
        # hot path's health without a dedicated RPC
        pipeline: list = []
        try:
            from ..telemetry.pipeline import live_stats as pipeline_stats
            pipeline = [{"run_id": ps.run_id, "gadget": ps.gadget,
                         **ps.snapshot()} for ps in pipeline_stats()]
        except Exception as e:  # noqa: BLE001 — debug dump stays best-effort
            pipeline = [{"error": repr(e)}]
        # accuracy audit plane (ISSUE 19): one row per audited run —
        # per-stat analytic bound vs observed error, sample size, drift
        # ratio — so `ig-tpu fleet accuracy` and the doctor accuracy row
        # read the envelope without a dedicated RPC
        accuracy: list = []
        try:
            from ..ops.accuracy import live_stats as accuracy_stats
            accuracy = [{"run_id": a.run_id, "gadget": a.gadget,
                         **a.snapshot()} for a in accuracy_stats()]
        except Exception as e:  # noqa: BLE001 — debug dump stays best-effort
            accuracy = [{"error": repr(e)}]
        # the node's alert table rides the same debug dump, so a remote
        # `ig-tpu alerts list` can read every agent's active alerts
        from ..alerts import ACTIVE as active_alerts
        msg = {"threads": frames, "active_runs": runs,
               "device": str(self.device),
               "runs": run_rows,
               "containers": containers,
               "alerts": active_alerts.all(),
               "history_tiers": history_tiers,
               "standing_queries": standing_queries,
               "pipeline": pipeline,
               "accuracy": accuracy,
               # CRD-path state rides the same debug dump (the reference's
               # daemon dumps its trace list alongside containers)
               "traces": [{"name": t["metadata"]["name"],
                           "gadget": t["spec"].get("gadget", ""),
                           "state": t["status"].get("state", ""),
                           "error": t["status"].get("operationError", "")}
                          for t in self.traces.list()]}
        if dump_error:
            msg["error"] = dump_error
        # the process flight recorder (recent spans/logs/errors/facts)
        # rides the same debug RPC, so a wedged agent can still be read;
        # max_spans lets trace export request the whole ring instead of
        # the 512-span debug default
        msg["flight_record"] = RECORDER.snapshot(
            max_spans=int(req.get("max_spans") or 512))
        return wire.encode_msg(msg)


def _traced_unary(name, behavior):
    """Open a server span per unary RPC, parented to the caller's span
    when the request header carries a traceparent."""
    def handler(request, context):
        parent = None
        try:
            h, _ = wire.decode_msg(request)
            parent = wire.extract_span(h)
        except (ValueError, KeyError, IndexError, UnicodeDecodeError,
                json.JSONDecodeError):
            parent = None
        with TRACER.span(f"agent/{name}", parent=parent):
            return behavior(request, context)
    return handler


def _method(behavior, kind, name=""):
    s, d = wire.identity_serializer, wire.identity_deserializer
    if kind == "unary":
        return grpc.unary_unary_rpc_method_handler(
            _traced_unary(name, behavior),
            request_deserializer=d, response_serializer=s)
    return grpc.stream_stream_rpc_method_handler(
        behavior, request_deserializer=d, response_serializer=s)


def serve(address: str = "unix:///tmp/igtpu-agent.sock",
          node_name: str = "node", max_workers: int = 8,
          checkpoint_dir: str = "",
          checkpoint_interval: float = 30.0,
          metrics_addr: str = "",
          device: str = "cuda") -> tuple[grpc.Server, AgentServer]:
    """Start the agent (non-blocking); returns (grpc_server, agent).
    metrics_addr ('host:port', off by default) additionally serves the
    telemetry registry as Prometheus text on GET /metrics. The port gRPC
    bound is `agent.port` (the chosen one for 'host:0'; 1 for a unix
    socket); an address gRPC cannot bind raises RuntimeError."""
    agent = AgentServer(node_name=node_name, device=device)
    # first agent in the process names the tracer/flight-recorder identity
    # (one agent per process in real deployments; in-process test fleets
    # share both, so keep the two first-wins-consistent — a last-wins
    # fact would contradict the span attribution)
    if not TRACER.node:
        TRACER.node = node_name
        RECORDER.set_fact("node", node_name)
    if metrics_addr:
        from ..telemetry import MetricsServer
        agent.metrics_server = MetricsServer(metrics_addr).start()
    if checkpoint_dir:
        agent.start_checkpointer(checkpoint_dir, checkpoint_interval)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    handlers = {
        "GetCatalog": _method(agent.get_catalog, "unary", "GetCatalog"),
        "RunGadget": _method(agent.run_gadget, "stream"),
        "AddContainer": _method(agent.add_container, "unary", "AddContainer"),
        "RemoveContainer": _method(agent.remove_container, "unary",
                                   "RemoveContainer"),
        "DumpState": _method(agent.dump_state, "unary", "DumpState"),
        "StartRecording": _method(agent.start_recording, "unary",
                                  "StartRecording"),
        "StopRecording": _method(agent.stop_recording, "unary",
                                 "StopRecording"),
        "ListRecordings": _method(agent.list_recordings, "unary",
                                  "ListRecordings"),
        "FetchSegment": _method(agent.fetch_segment, "unary", "FetchSegment"),
        "ListWindows": _method(agent.list_windows, "unary", "ListWindows"),
        "FetchWindows": _method(agent.fetch_windows, "unary",
                                "FetchWindows"),
        "QueryWindows": _method(agent.query_windows, "unary",
                                "QueryWindows"),
        "ApplyTrace": _method(agent.apply_trace, "unary", "ApplyTrace"),
        "GetTrace": _method(agent.get_trace, "unary", "GetTrace"),
        "ListTraces": _method(agent.list_traces, "unary", "ListTraces"),
        "DeleteTrace": _method(agent.delete_trace, "unary", "DeleteTrace"),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("igtpu.GadgetManager", handlers),
    ))
    # standard health service analogue (ref: main.go:224-245); gRPC
    # answers 0 (or raises) for an address it could not bind — a stale
    # socket path, a port taken — and an agent that never listens must
    # not look started
    try:
        port = server.add_insecure_port(address)
    except RuntimeError as e:
        port, why = 0, f": {e}"
    else:
        why = ""
    if not port:
        agent.stop_checkpointer()
        if agent.metrics_server is not None:
            agent.metrics_server.stop()
        raise RuntimeError(f"agent could not bind {address!r}{why}")
    agent.port = port
    server.start()
    return server, agent
