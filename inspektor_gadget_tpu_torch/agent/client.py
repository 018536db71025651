"""AgentClient: one node's gRPC connection.

Reference contract: pkg/runtime/grpc — dial (k8s-exec tunnel there, plain
grpc target here), GetCatalog with client-side cache fallback
(grpc-runtime.go:62-91), RunGadget stream with seq-gap detection
(:312-314) and a stop request + bounded result wait (:336-353).

The port's copy of ``inspektor_gadget_tpu/agent/client.py``: the same
methods and wire messages, so it drives a port agent and a reference
agent alike. One keyword more: `run_gadget(stop_run=True)` sends the
reference agent's whole-run stop (``{"stop": "run"}``) for a shared run.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Iterator

import grpc

from . import wire

CONNECT_TIMEOUT = 30.0      # ref: grpc-runtime.go:45-52
RESULT_TIMEOUT = 30.0

CATALOG_CACHE = Path.home() / ".ig-tpu" / "catalog.json"

# the shared subscriber-option vocabulary lives in wire.py (one home for
# client, agent, and params layer): the client refuses a bad attach
# BEFORE it goes on the wire, the agent refuses it again server-side —
# loud both ways, silent nowhere
DROP_POLICIES = wire.DROP_POLICIES
PRIORITIES = wire.PRIORITIES
TIERS = wire.TIERS


def _validate_subscriber_opts(opts: dict) -> None:
    """Raise ValueError on malformed subscriber options (the params
    layer applies the same vocabulary to the runtime flags)."""
    unknown = set(opts) - {"id", "priority", "drop_policy", "queue",
                           "evict_after", "tier"}
    if unknown:
        raise ValueError(f"unknown subscriber option(s) {sorted(unknown)}")
    if opts.get("drop_policy") is not None \
            and opts["drop_policy"] not in DROP_POLICIES:
        raise ValueError(f"drop_policy must be one of {DROP_POLICIES}, "
                         f"got {opts['drop_policy']!r}")
    if opts.get("priority") is not None \
            and opts["priority"] not in PRIORITIES:
        raise ValueError(f"priority must be one of {PRIORITIES}, "
                         f"got {opts['priority']!r}")
    if opts.get("tier") is not None and opts["tier"] not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, "
                         f"got {opts['tier']!r}")
    if opts.get("queue") is not None and int(opts["queue"]) < 1:
        raise ValueError(f"subscriber queue bound must be >= 1, "
                         f"got {opts['queue']}")
    if opts.get("evict_after") is not None \
            and float(opts["evict_after"]) <= 0:
        raise ValueError(f"evict_after must be > 0, "
                         f"got {opts['evict_after']}")


class AgentClient:
    def __init__(self, target: str, node_name: str = "", dialer=None,
                 rpc_deadline: float | None = None):
        """dialer: how to reach the agent (default DirectDialer). An
        ExecTunnelDialer reaches agents with no routable address by
        tunneling over a subprocess's stdio — the reference's
        k8s-exec-dialer contract (k8s-exec-dialer.go:1-132).

        rpc_deadline bounds every unary RPC (catalog, dump_state,
        list/fetch, recording lifecycle): an unresponsive agent fails the
        call with DEADLINE_EXCEEDED instead of wedging the caller.
        Default $IG_RPC_DEADLINE or 30s."""
        from .dialer import DirectDialer
        self.target = target
        self.node_name = node_name or target
        self.dialer = dialer or DirectDialer()
        if rpc_deadline is None:
            rpc_deadline = float(os.environ.get("IG_RPC_DEADLINE",
                                                CONNECT_TIMEOUT))
        if rpc_deadline <= 0:
            raise ValueError(f"rpc_deadline must be > 0, got {rpc_deadline}")
        self.rpc_deadline = rpc_deadline
        self.channel = self.dialer.dial(target)

    def close(self) -> None:
        self.channel.close()
        self.dialer.close()

    def reconnect(self) -> None:
        """Tear down the (possibly wedged) channel and dial a fresh one.
        The supervisor calls this between retry attempts so a channel
        stuck in TRANSIENT_FAILURE backoff doesn't slow the resume."""
        try:
            self.channel.close()
        except Exception as e:  # noqa: BLE001 — a dead channel may refuse close
            logging.getLogger("ig-tpu.client").debug(
                "channel close before redial failed: %r", e)
        self.channel = self.dialer.dial(self.target)

    # -- catalog ------------------------------------------------------------

    def get_catalog(self, use_cache_on_error: bool = True) -> dict:
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/GetCatalog",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        try:
            reply = method(wire.encode_msg({}), timeout=self.rpc_deadline)
            header, _ = wire.decode_msg(reply)
            catalog = header["catalog"]
            try:  # cache for offline flag rendering (ref: catalog cache)
                CATALOG_CACHE.parent.mkdir(parents=True, exist_ok=True)
                CATALOG_CACHE.write_text(json.dumps(catalog))
            except OSError:
                pass
            return catalog
        except grpc.RpcError:
            if use_cache_on_error and CATALOG_CACHE.exists():
                return json.loads(CATALOG_CACHE.read_text())
            raise

    # -- run ----------------------------------------------------------------

    def run_gadget(
        self,
        category: str,
        name: str,
        params: dict[str, str] | None = None,
        *,
        timeout: float = 0.0,
        outputs: tuple[str, ...] = ("json",),
        on_json: Callable[[str, dict], None] | None = None,
        on_array: Callable[[str, list], None] | None = None,
        on_batch: Callable[[str, Any], None] | None = None,
        on_summary: Callable[[str, dict], None] | None = None,
        on_alert: Callable[[str, dict], None] | None = None,
        on_log: Callable[[str, int, str, dict], None] | None = None,
        on_message: Callable[[str, int, int], None] | None = None,
        on_window: Callable[[str, dict], None] | None = None,
        on_query: Callable[[str, dict, bytes], None] | None = None,
        stop_event: threading.Event | None = None,
        trace_ctx=None,
        run_id: str | None = None,
        resumable: bool = False,
        linger: float | None = None,
        ring: int | None = None,
        resume_from: int | None = None,
        share: bool = False,
        keepalive: float | None = None,
        max_subscribers: int | None = None,
        sub_budget: int | None = None,
        subscriber: dict | None = None,
        attach_to: str | None = None,
        sub_id: str | None = None,
        stop_run: bool = False,
    ) -> dict:
        """Blocking run; returns {'result': bytes|None, 'error': str|None,
        'gaps': int, 'dropped': int, 'records': int, 'last_seq': int,
        'resume': dict|None, 'unknown_run': bool, 'gadget_error': bool}.
        trace_ctx (a telemetry SpanContext) rides the run request as a
        traceparent so the agent's server spans join the caller's trace;
        on_log receives (node, severity, msg, header) — the header
        carries the remote run_id/trace_id; on_message(node, seq, type)
        fires for every seq-bearing stream message (supervision's
        record-cadence hook).

        resumable=True asks the agent to keep the run alive for `linger`
        seconds after a disconnect, retaining the last `ring` messages
        for replay; resume_from re-attaches to an existing run (run_id
        required) and receives messages after that seq — the agent
        answers with an EV_RESUME_ACK (surfaced as out['resume']) or
        `unknown_run` when it has nothing to resume (it restarted).

        Shared runs: share=True makes the run a first-class shared
        resource — the first request for a (gadget, params, outputs) key
        starts the gadget, compatible requests attach as SUBSCRIBERS to
        the same pipeline (out['attach'] carries the typed ack; a
        refused admission surfaces out['attach_refused']). `subscriber`
        ({id, priority, drop_policy, queue, evict_after, tier}) shapes
        this consumer's delivery: a slow subscriber drops its OWN
        records (EV_DROP_NOTICE → out['sub_drops']) and one stalled past
        evict_after is EVICTED (out['evicted'] + labeled terminal
        record) — never stalling the gadget or its peers. keepalive /
        max_subscribers / sub_budget are run-level (first request wins).
        attach_to joins an existing run by run_id WITHOUT a run request
        (tier='summary' subscribers get harvest summaries, alerts, and
        sealed-window announcements only — on_window receives the
        announcements). resume with sub_id re-attaches one subscriber.

        stop_run=True makes stop_event end the whole run for every
        subscriber (the agent's ``{"stop": "run"}`` request) instead of
        only this subscriber's attachment: the subscribers still
        attached then receive the run's final harvest."""
        method = self.channel.stream_stream(
            "/igtpu.GadgetManager/RunGadget",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        ctrl_q: queue.Queue = queue.Queue()
        sub_opts = dict(subscriber or {})
        if sub_opts:
            _validate_subscriber_opts(sub_opts)
        if resume_from is not None:
            if not run_id:
                raise ValueError("resume_from requires run_id")
            resume_msg = {"run_id": run_id, "last_seq": int(resume_from)}
            if sub_id:
                resume_msg["sub_id"] = sub_id
            first_msg = {"resume": resume_msg}
        elif attach_to is not None:
            first_msg = {"attach": {**sub_opts, "run_id": attach_to}}
        else:
            run: dict = {
                "category": category, "name": name, "params": params or {},
                "timeout": timeout, "output": list(outputs),
            }
            if run_id:
                run["run_id"] = run_id
            if resumable:
                run["resumable"] = True
                if linger is not None:
                    run["linger"] = float(linger)
                if ring is not None:
                    run["ring"] = int(ring)
            if share:
                run["share"] = True
            if keepalive is not None:
                run["keepalive"] = float(keepalive)
            if max_subscribers is not None:
                run["max_subscribers"] = int(max_subscribers)
            if sub_budget is not None:
                run["sub_budget"] = int(sub_budget)
            if sub_opts:
                run["subscriber"] = sub_opts
            first_msg = {"run": run}
        ctrl_q.put(wire.encode_msg(wire.inject_span(first_msg, trace_ctx)))

        def requests() -> Iterator[bytes]:
            while True:
                item = ctrl_q.get()
                if item is None:
                    return
                yield item

        if stop_event is not None:
            def stopper():
                stop_event.wait()
                ctrl_q.put(wire.encode_msg({"stop": "run" if stop_run else True}))
                ctrl_q.put(None)
            threading.Thread(target=stopper, daemon=True).start()

        out = {"result": None, "error": None, "gaps": 0, "dropped": 0,
               "records": 0, "last_seq": int(resume_from or 0),
               "resume": None, "unknown_run": False, "gadget_error": False,
               "attach": None, "attach_refused": "", "sub_drops": 0,
               "drop_notices": 0, "evicted": False}
        # resuming: seq numbering continues from what we already hold, so
        # gap detection spans the outage — a replay ring that overflowed
        # shows up as a gap here (and as `missed` in the resume ack)
        last_seq = int(resume_from or 0)
        call = method(requests(), timeout=None if timeout == 0 else timeout + RESULT_TIMEOUT)
        try:
            for msg in call:
                header, payload = wire.decode_msg(msg)
                seq = header.get("seq", 0)
                if seq and last_seq and seq != last_seq + 1:
                    out["gaps"] += seq - last_seq - 1  # ref: seq-gap :312-314
                if seq:
                    last_seq = seq
                    out["last_seq"] = seq
                    out["records"] += 1
                    if on_message is not None:
                        on_message(self.node_name, seq,
                                   header.get("type", 0))
                t = header.get("type", 0)
                sev = t >> wire.EV_LOG_SHIFT
                if sev:
                    if on_log:
                        on_log(self.node_name, sev,
                               payload.decode("utf-8", "replace"), header)
                elif t == wire.EV_PAYLOAD_JSON:
                    if on_json:
                        on_json(self.node_name, json.loads(payload))
                elif t == wire.EV_PAYLOAD_ARRAY:
                    if on_array:
                        on_array(self.node_name, json.loads(payload))
                elif t == wire.EV_BATCH_NPZ:
                    if on_batch:
                        on_batch(self.node_name, wire.decode_batch(payload))
                elif t == wire.EV_SUMMARY:
                    if on_summary:
                        on_summary(self.node_name, wire.decode_summary(header, payload))
                elif t == wire.EV_ALERT:
                    if on_alert:
                        on_alert(self.node_name, header.get("alert", {}))
                elif t == wire.EV_RESULT:
                    out["error"] = header.get("error")
                    out["result"] = payload or None
                    if header.get("error"):
                        out["gadget_error"] = True
                elif t == wire.EV_CONTROL_ACK:
                    out["dropped"] = header.get("dropped", 0)
                elif t == wire.EV_RESUME_ACK:
                    out["resume"] = header.get("resume", {})
                elif t == wire.EV_ATTACH_ACK:
                    a = header.get("attach", {})
                    out["attach"] = a
                    if a.get("refused"):
                        # typed admission refusal: deterministic — the
                        # supervisor must surface it, never retry it
                        out["attach_refused"] = a.get("reason", "refused")
                        out["error"] = header.get("error") or \
                            f"attach refused ({out['attach_refused']})"
                        out["gadget_error"] = True
                elif t == wire.EV_DROP_NOTICE:
                    # this subscriber's own overload accounting: its
                    # bounded queue dropped records (policy/class in the
                    # header); evicted=True is the labeled terminal
                    # record of a stalled subscriber
                    out["drop_notices"] += 1
                    out["sub_drops"] = max(
                        out["sub_drops"], int(header.get("drops_total", 0)))
                    if header.get("evicted"):
                        out["evicted"] = True
                        out["error"] = (f"subscriber evicted: "
                                        f"{header.get('reason', '?')}")
                        out["gadget_error"] = True
                elif t == wire.EV_WINDOW:
                    if on_window:
                        on_window(self.node_name,
                                  header.get("window", {}))
                elif t == wire.EV_QUERY:
                    # standing-query materialized answer: header is the
                    # query identity + coverage, payload the packed
                    # sealed window (QueryWindows reply frame shape)
                    if on_query:
                        on_query(self.node_name,
                                 header.get("query", {}), payload)
                elif "error" in header:
                    out["error"] = header["error"]
                    if header.get("unknown_run"):
                        out["unknown_run"] = True
                    else:
                        # run-setup refusals (unknown gadget, bad params)
                        # are deterministic — retrying replays the failure
                        out["gadget_error"] = True
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                out["error"] = f"{e.code().name}: {e.details()}"
        finally:
            ctrl_q.put(None)
        return out

    # -- container hooks (ref: hooks/oci/main.go) ---------------------------

    def add_container(self, container: dict,
                      timeout: float = CONNECT_TIMEOUT) -> dict:
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/AddContainer",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        h, _ = wire.decode_msg(method(wire.encode_msg({"container": container}),
                                      timeout=timeout))
        return h

    def remove_container(self, container_id: str,
                         timeout: float = CONNECT_TIMEOUT) -> dict:
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/RemoveContainer",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        h, _ = wire.decode_msg(method(
            wire.encode_msg({"container": {"id": container_id}}),
            timeout=timeout))
        return h

    def dump_state(self, max_spans: int = 0) -> dict:
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/DumpState",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        req = {"max_spans": max_spans} if max_spans else {}
        h, _ = wire.decode_msg(method(wire.encode_msg(req),
                                      timeout=self.rpc_deadline))
        return h

    def shared_runs(self, gadget: str = "") -> list[dict]:
        """Live shared runs on this node (DumpState `runs` rows filtered
        to shared + not-done), the attach-by-key discovery surface: each
        row carries run_id, subscriber rows, queue depths, drops, and
        keepalive state."""
        rows = self.dump_state().get("runs") or []
        return [r for r in rows
                if r.get("shared") and not r.get("done")
                and (not gadget or r.get("gadget") == gadget)]

    def flight_record(self, max_spans: int = 0) -> dict:
        """The agent's flight recorder (recent spans/logs/errors/facts),
        served via DumpState. max_spans>512 pulls deeper into the span
        ring (trace export wants all of it)."""
        return self.dump_state(max_spans=max_spans).get("flight_record", {})

    # -- capture/recording lifecycle (capture/) -----------------------------

    def start_recording(self, recording_id: str, *,
                        opts: dict | None = None) -> dict:
        """Journals land under the AGENT's capture area (--capture-dir)
        — the same base ListRecordings/FetchSegment resolve against."""
        return self._unary("StartRecording",
                           {"recording_id": recording_id,
                            "opts": opts or {}})

    def stop_recording(self, recording_id: str) -> dict:
        return self._unary("StopRecording", {"recording_id": recording_id})

    def list_recordings(self, recording_id: str = "") -> dict:
        return self._unary("ListRecordings",
                           {"recording_id": recording_id})

    def fetch_file(self, recording_id: str, rel_path: str,
                   dest_path: str, *, chunk: int = 1 << 20) -> int:
        """Download one recording file in chunks; returns bytes written.
        The chunked unary keeps every message under gRPC's 4 MiB cap."""
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/FetchSegment",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        written = 0
        with open(dest_path, "wb") as f:
            offset = 0
            while True:
                reply = method(wire.encode_msg(
                    {"recording_id": recording_id, "file": rel_path,
                     "offset": offset, "limit": chunk}),
                    timeout=self.rpc_deadline)
                h, payload = wire.decode_msg(reply)
                if h.get("error"):
                    raise RuntimeError(h["error"])
                f.write(payload)
                written += len(payload)
                offset += len(payload)
                if h.get("eof") or not payload:
                    break
        return written

    def fetch_recording(self, recording_id: str, dest_dir: str) -> dict:
        """Pull every file of one recording into dest_dir (mirroring the
        node's relative layout); returns {files, bytes}. The server's
        listing is NOT trusted: an absolute or ..-escaping relative path
        from a compromised agent must not write outside dest_dir
        (zip-slip), so such entries are refused loudly."""
        listing = self.list_recordings(recording_id)
        files = listing.get("files") or []
        total = 0
        for item in files:
            rel = os.path.normpath(item["path"])
            if os.path.isabs(rel) or rel.startswith(".."):
                raise RuntimeError(
                    f"{self.node_name}: refusing listed path {item['path']!r}"
                    " escaping the bundle directory")
            total += self.fetch_file(recording_id, item["path"],
                                     os.path.join(dest_dir, rel))
        return {"files": len(files), "bytes": total}

    # -- sketch-history plane (history/) ------------------------------------

    def list_windows(self, *, gadget: str = "",
                     start_ts: float | None = None,
                     end_ts: float | None = None,
                     start_seq: int | None = None,
                     end_seq: int | None = None,
                     key: str | None = None) -> dict:
        """Header rows of this node's sealed windows overlapping the
        range/slice — the cheap pruning pass before fetch_windows."""
        return self._unary("ListWindows", {
            "gadget": gadget, "start_ts": start_ts, "end_ts": end_ts,
            "start_seq": start_seq, "end_seq": end_seq, "key": key})

    def fetch_windows(self, *, gadget: str = "",
                      start_ts: float | None = None,
                      end_ts: float | None = None,
                      start_seq: int | None = None,
                      end_seq: int | None = None,
                      key: str | None = None,
                      chunk_bytes: int = 1 << 20
                      ) -> tuple[list[tuple[dict, bytes]], list[dict]]:
        """Pull every matching window's (header, payload) frame in
        chunks under the gRPC cap; returns (frames, torn-tail losses).
        A truncated reply tail is dropped-and-accounted client-side with
        the same rule a torn segment gets."""
        from ..history import unpack_frames
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/FetchWindows",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        frames: list[tuple[dict, bytes]] = []
        losses: list[dict] = []
        offset = 0
        while True:
            reply = method(wire.encode_msg({
                "gadget": gadget, "start_ts": start_ts, "end_ts": end_ts,
                "start_seq": start_seq, "end_seq": end_seq, "key": key,
                "offset": offset, "max_bytes": chunk_bytes}),
                timeout=self.rpc_deadline)
            h, payload = wire.decode_msg(reply)
            if h.get("error"):
                raise RuntimeError(h["error"])
            got, dropped = unpack_frames(payload)
            frames.extend(got)
            losses.extend(h.get("losses") or [])
            if dropped:
                losses.append({"store": "<fetch>", "segment": "<reply>",
                               "offset": offset, "dropped_bytes": dropped,
                               "reason": "truncated fetch reply"})
            if h.get("eof") or not h.get("count"):
                return frames, losses
            offset = int(h.get("next_offset", offset + len(got)))

    def query_windows(self, *, gadget: str = "",
                      start_ts: float | None = None,
                      end_ts: float | None = None,
                      start_seq: int | None = None,
                      end_seq: int | None = None,
                      key: str | None = None) -> dict:
        """Query pushdown: the agent folds the range/slice query
        node-side and returns ONE merged window plus accounting —
        fleet-query wire cost O(nodes), not O(windows). Raises
        grpc.RpcError UNIMPLEMENTED against pre-pushdown agents (the
        runtime falls back to list+fetch per node) and RuntimeError on
        a typed server-side refusal."""
        from ..history import decode_frames, unpack_frames
        method = self.channel.unary_unary(
            "/igtpu.GadgetManager/QueryWindows",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        reply = method(wire.encode_msg({
            "gadget": gadget, "start_ts": start_ts, "end_ts": end_ts,
            "start_seq": start_seq, "end_seq": end_seq, "key": key}),
            timeout=self.rpc_deadline)
        h, payload = wire.decode_msg(reply)
        if h.get("error"):
            raise RuntimeError(h["error"])
        frames, dropped_bytes = unpack_frames(payload)
        wins = decode_frames(frames)
        losses = list(h.get("losses") or [])
        if dropped_bytes:
            losses.append({"store": "<query>", "segment": "<reply>",
                           "offset": 0, "dropped_bytes": dropped_bytes,
                           "reason": "truncated query reply"})
        return {
            "node": h.get("node", self.node_name),
            "window": wins[0] if wins else None,
            "folded": int(h.get("folded", 0)),
            "levels": {int(k): int(v)
                       for k, v in (h.get("levels") or {}).items()},
            "torn": int(h.get("torn", 0)),
            "dropped": list(h.get("dropped") or []),
            "losses": losses,
        }

    # -- Trace resources (ref: utils/trace.go:340-848 CreateTrace/
    #    SetTraceOperation/getTraceListFromOptions, over agent RPCs) --------

    def _unary(self, name: str, msg: dict) -> dict:
        method = self.channel.unary_unary(
            f"/igtpu.GadgetManager/{name}",
            request_serializer=wire.identity_serializer,
            response_deserializer=wire.identity_deserializer,
        )
        # per-RPC deadline: an unresponsive agent fails this call with
        # DEADLINE_EXCEEDED instead of hanging dump_state/list_windows
        h, _ = wire.decode_msg(method(wire.encode_msg(msg),
                                      timeout=self.rpc_deadline))
        if h.get("error"):
            raise RuntimeError(h["error"])
        return h

    def apply_trace(self, doc: dict) -> dict:
        return self._unary("ApplyTrace", {"trace": doc})["trace"]

    def get_trace(self, name: str) -> dict:
        return self._unary("GetTrace", {"name": name})["trace"]

    def list_traces(self) -> list[dict]:
        return self._unary("ListTraces", {})["traces"]

    def delete_trace(self, name: str) -> bool:
        return self._unary("DeleteTrace", {"name": name})["deleted"]
