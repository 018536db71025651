"""GrpcRuntime: client-side fan-out over all node agents.

Reference contract: pkg/runtime/grpc/grpc-runtime.go — RunGadget :185-239
spawns one goroutine + stream per gadget pod, node-filter param, per-node
error isolation in CombinedGadgetResult, interval snapshots merged via the
snapshot combiner (:196-207), one-shot events accumulated then flushed,
stop-request fan-out with a 30s result timeout (:336-353).

TPU-native addition: a "summary" output mode where nodes stream sketch
digests instead of raw events; the client merges digests (mergeable by
construction) — the low-bandwidth analogue of the psum path used when
nodes don't share a TPU slice.

The port's copy of ``inspektor_gadget_tpu/runtime/grpc_runtime.py``: the
same params, verbs, per-node accounting and ``ig_runtime_*`` metrics (in
the port's own registry), over the port's `AgentClient`, so it fans out
to port agents and reference agents alike (both speak the same
``ig.proto`` bytes). ``query_history(topology=...)`` routes the fold
through the port's aggregation tier (`fleet.fold_tree`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetType
from ..params import ParamDesc, ParamDescs, TypeHint, parse_duration
from ..snapshotcombiner import SnapshotCombiner
from ..telemetry import counter, gauge
from ..telemetry.tracing import TRACER
from .runtime import CombinedGadgetResult, GadgetResult, Runtime
from .supervisor import FleetHealth, NodeSupervisor, RetryPolicy, classify_error

STOP_RESULT_TIMEOUT = 30.0  # default; ref: grpc-runtime.go:347-353
                            # (runtime param stop-result-timeout overrides)

# fan-out telemetry: message-grain per node (a message carries a row array
# or batch); lag is read at SCRAPE time as the age of the node's last
# message — a node whose gauge grows while its peers' stay flat is stalled
# or unreachable (an on-message gauge would freeze at its last healthy
# value during exactly that outage)
_tm_node_events = counter("ig_runtime_node_events_total",
                          "rows received from each node's stream", ("node",))
_tm_node_errors = counter("ig_runtime_node_errors_total",
                          "per-node gadget-run errors by class "
                          "(transport = flaky network, retried with "
                          "resume; fatal = broken gadget, not retried)",
                          ("node", "class"))
_tm_seq_gaps = counter("ig_runtime_seq_gaps_total",
                       "stream messages lost in transit per node "
                       "(client-observed seq gaps, incl. resume-ring "
                       "overflow during outages)", ("node",))
_tm_node_lag = gauge("ig_runtime_node_stream_lag_seconds",
                     "seconds since each node's last stream message "
                     "(grows while a node is stalled)", ("node",))


def _validate_positive_duration(value: str) -> None:
    if parse_duration(value) <= 0:
        raise ValueError(f"duration {value!r} must be > 0")


class GrpcRuntime(Runtime):
    name = "grpc"

    def __init__(self, targets: dict[str, str], dialer_factory=None):
        """targets: node_name → grpc target (host:port or unix:///path).
        dialer_factory(node, target) -> Dialer lets fan-out reach agents
        with no routable address (exec tunnels — k8s-exec-dialer.go)."""
        self.targets = targets
        self.dialer_factory = dialer_factory
        self._clients: dict[str, Any] = {}

    def params(self) -> ParamDescs:
        from ..agent import wire
        from ..params.validators import validate_int_range, validate_one_of
        return ParamDescs([
            ParamDesc(key="node", default="",
                      description="restrict to one node"),
            ParamDesc(key="stop-result-timeout",
                      default=f"{STOP_RESULT_TIMEOUT:g}s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="how long to wait for node results "
                                  "after the stop fan-out (ref: "
                                  "grpc-runtime.go:347-353)"),
            ParamDesc(key="supervise", default="true",
                      type_hint=TypeHint.BOOL,
                      description="supervise node streams: reconnect "
                                  "with resume on transport errors "
                                  "instead of abandoning the node"),
            ParamDesc(key="retry-base", default="200ms",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="reconnect backoff base (full-jitter "
                                  "exponential)"),
            ParamDesc(key="retry-cap", default="3s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="reconnect backoff ceiling"),
            ParamDesc(key="retry-horizon", default="30s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="outage length after which a node is "
                                  "labeled dead (retries continue at the "
                                  "capped rate; a later heal resurrects "
                                  "it)"),
            ParamDesc(key="attempt-deadline", default="5s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="per-attempt connect deadline while "
                                  "reconnecting"),
            ParamDesc(key="resume-linger", default="10s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="how long the agent keeps a "
                                  "disconnected run alive awaiting a "
                                  "resume"),
            ParamDesc(key="resume-ring", default="1024",
                      type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1),
                      description="outbound messages the agent retains "
                                  "for seq replay on resume"),
            ParamDesc(key="straggler-factor", default="4.0",
                      type_hint=TypeHint.FLOAT,
                      description="a node silent for more than this × "
                                  "the fleet's rolling inter-record p95 "
                                  "is marked straggling"),
            ParamDesc(key="straggler-floor", default="1s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="minimum straggler silence threshold "
                                  "(no flapping on µs cadences)"),
            ParamDesc(key="backfill", default="true",
                      type_hint=TypeHint.BOOL,
                      description="heal seq gaps from the node's sealed "
                                  "history windows after an outage"),
            # shared-run multiplexing + overload protection: validated
            # LOUDLY here (the stop-result-timeout pattern) before the
            # first attach ever goes on the wire
            ParamDesc(key="share", default="false",
                      type_hint=TypeHint.BOOL,
                      description="share the gadget run: the first "
                                  "request for a (gadget, params, "
                                  "outputs) key starts the gadget, "
                                  "compatible requests attach as "
                                  "subscribers to the same pipeline"),
            ParamDesc(key="max-subscribers", default="16",
                      type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1),
                      description="admission cap on subscribers per "
                                  "shared run"),
            ParamDesc(key="sub-queue", default="1024",
                      type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1),
                      description="per-subscriber bounded delivery "
                                  "queue (messages); a slow consumer "
                                  "drops its own records, never its "
                                  "peers'"),
            ParamDesc(key="sub-budget", default="16384",
                      type_hint=TypeHint.INT,
                      validator=validate_int_range(lo=1),
                      description="per-run queued-capacity budget "
                                  "across all subscribers; low-priority "
                                  "admissions are refused first near "
                                  "the budget"),
            ParamDesc(key="drop-policy", default="drop-oldest",
                      validator=validate_one_of(wire.DROP_POLICIES),
                      description="which record a full subscriber "
                                  "queue sacrifices"),
            ParamDesc(key="priority", default="normal",
                      validator=validate_one_of(wire.PRIORITIES),
                      description="this subscriber's admission/"
                                  "protection class under overload"),
            ParamDesc(key="evict-after", default="10s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="a subscriber stalled (queue full, "
                                  "client not draining) longer than "
                                  "this is evicted with a labeled "
                                  "terminal record"),
            ParamDesc(key="run-keepalive", default="10s",
                      type_hint=TypeHint.DURATION,
                      validator=_validate_positive_duration,
                      description="after the last subscriber detaches "
                                  "the gadget keeps running this long "
                                  "awaiting a re-attach (no capture "
                                  "thrash on dashboard churn)"),
        ])

    def _rp(self, ctx: GadgetContext, key: str):
        """Runtime param with default fallback: contexts built without
        this runtime's params (tests, older callers) get the documented
        defaults instead of KeyErrors."""
        if key in ctx.runtime_params:
            return ctx.runtime_params.get(key)
        return self.params().get(key).to_param()

    def _client(self, node: str):
        from ..agent.client import AgentClient
        if node not in self._clients:
            dialer = (self.dialer_factory(node, self.targets[node])
                      if self.dialer_factory else None)
            self._clients[node] = AgentClient(self.targets[node], node,
                                              dialer=dialer)
        return self._clients[node]

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        self._clients.clear()

    def get_catalog(self) -> dict:
        for node in self.targets:
            try:
                return self._client(node).get_catalog()
            except Exception:
                continue
        return super().get_catalog()

    # -- recording lifecycle fan-out (capture/) -----------------------------

    def _fanout_unary(self, fn, nodes=None) -> tuple[dict, dict]:
        """(per-node results, per-node errors) — the per-node isolation
        contract every fan-out verb follows (runtime.go:42-79)."""
        results: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for node in (nodes or self.targets):
            try:
                results[node] = fn(self._client(node))
            except Exception as e:  # noqa: BLE001 — per-node isolation
                errors[node] = str(e)
        return results, errors

    def start_recording(self, recording_id: str,
                        opts: dict | None = None) -> tuple[dict, dict]:
        return self._fanout_unary(
            lambda c: c.start_recording(recording_id, opts=opts))

    def stop_recording(self, recording_id: str) -> tuple[dict, dict]:
        return self._fanout_unary(lambda c: c.stop_recording(recording_id))

    def list_recordings(self, recording_id: str = "") -> tuple[dict, dict]:
        return self._fanout_unary(lambda c: c.list_recordings(recording_id))

    def fetch_recording(self, recording_id: str, dest_dir: str) -> dict:
        """Pull every node's journals for one recording into a single
        client-side bundle:

            <dest_dir>/
              bundle.json          # which nodes, how much, what failed
              <node>/<journal>/... # each node's recording dir, verbatim

        Per-node errors are recorded in the bundle manifest, never
        fatal — a crashed node's journals are exactly the ones worth
        fetching from its peers."""
        import json
        import os
        import time as _time
        per_node: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for node in self.targets:
            try:
                per_node[node] = self._client(node).fetch_recording(
                    recording_id, os.path.join(dest_dir, node))
            except Exception as e:  # noqa: BLE001 — per-node isolation
                errors[node] = str(e)
        bundle = {
            "schema": "ig-tpu/capture-bundle/v1",
            "recording_id": recording_id,
            "fetched_ts": _time.time(),
            "nodes": per_node,
            "errors": errors,
        }
        os.makedirs(dest_dir, exist_ok=True)
        with open(os.path.join(dest_dir, "bundle.json"), "w",
                  encoding="utf-8") as f:
            json.dump(bundle, f, sort_keys=True, indent=2)
        return bundle

    # -- sketch-history fan-out (history/) ----------------------------------

    def list_windows(self, **kw) -> tuple[dict, dict]:
        """Per-node sealed-window header rows overlapping a range/slice
        (kw: gadget, start_ts/end_ts, start_seq/end_seq, key)."""
        return self._fanout_unary(lambda c: c.list_windows(**kw))

    def fetch_windows(self, **kw) -> tuple[dict, dict]:
        """Per-node (frames, losses) for every matching window. The
        pull is index-guided: each node is first asked to LIST, and
        nodes with zero overlapping windows are never asked for bytes."""
        def pull(c):
            listing = c.list_windows(**kw)
            if not listing.get("windows"):
                return {"frames": [], "losses": listing.get("losses") or []}
            frames, losses = c.fetch_windows(**kw)
            return {"frames": frames, "losses": losses}
        return self._fanout_unary(pull)

    def query_history(self, *, key: str | None = None, top: int = 20,
                      pushdown: bool = True, topology=None, **kw) -> "Any":
        """The fleet-wide range query. Preferred path: QueryWindows
        PUSHDOWN — every agent folds the query node-side and ships ONE
        merged window, so wire cost is O(nodes) instead of O(windows).
        Agents that predate the RPC (UNIMPLEMENTED) fall back PER NODE
        to the list+fetch pull, and the answer records which path
        each node took (`answer.paths`). Per-node errors are recorded
        in the answer, never fatal: a crashed node's peers still answer
        for their share.

        With `topology` (a fleet.Topology or a spec string — "auto",
        "auto:<fan_in>", or the declared zone grammar), the fold routes
        through the aggregation tier instead of one flat client loop:
        per-node summaries fold zone-by-zone up the merge tree
        (fleet.fold_tree), byte-identical to the flat fold by the merge
        algebra's associativity, with per-leaf path accounting and a
        flat re-fold of any subtree whose aggregator fails. The tree's
        shape accounting lands in `answer.fleet`."""
        import grpc as _grpc

        from ..history import (answer_query, decode_frames,
                               dedupe_compacted, level_counts)

        if topology is not None:
            return self._query_history_tree(
                topology, key=key, top=top, pushdown=pushdown, **kw)
        windows = []
        dropped: list[str] = []
        errors: dict[str, str] = {}
        paths: dict[str, str] = {}
        levels_total: dict[int, int] = {}

        def add_levels(levels: dict[int, int]) -> None:
            for lvl, n in levels.items():
                levels_total[lvl] = levels_total.get(lvl, 0) + n

        def add_losses(node: str, losses) -> None:
            for loss in losses or ():
                dropped.append(f"{node}: torn window tail "
                               f"({loss.get('reason', '?')}, "
                               f"{loss.get('dropped_bytes', 0)} bytes)")

        for node in self.targets:
            client = self._client(node)
            res = None
            if pushdown:
                try:
                    res = client.query_windows(key=key, **kw)
                except _grpc.RpcError as e:
                    if e.code() != _grpc.StatusCode.UNIMPLEMENTED:
                        errors[node] = f"{e.code().name}: {e.details()}"
                        paths[node] = "pushdown"
                        continue
                    # pre-pushdown agent: fall through to list+fetch
                except Exception as e:  # noqa: BLE001 — per-node isolation
                    errors[node] = str(e)
                    paths[node] = "pushdown"
                    continue
            if res is not None:
                paths[node] = "pushdown"
                if res["window"] is not None:
                    windows.append(res["window"])
                add_levels(res["levels"])
                for note in res["dropped"]:
                    dropped.append(f"{node}: {note}")
                add_losses(node, res["losses"])
                continue
            paths[node] = "fetch"
            try:
                listing = client.list_windows(key=key, **kw)
                if listing.get("windows"):
                    frames, losses = client.fetch_windows(key=key, **kw)
                else:
                    frames, losses = [], listing.get("losses") or []
                kept, notes = dedupe_compacted(decode_frames(frames))
                windows.extend(kept)
                add_levels(level_counts(kept))
                for note in notes:
                    dropped.append(f"{node}: {note}")
                add_losses(node, losses)
            except Exception as e:  # noqa: BLE001 — per-node isolation
                errors[node] = str(e)
        # determinism pin: fold in canonical window order, not reply
        # arrival order — the merge's label-map update is last-wins and
        # its geometry base is first-wins, so an unsorted fold would let
        # scheduling leak into the summary bytes (and break the tree
        # tier's byte-identity anchor)
        from ..fleet import canonical_order
        return answer_query(canonical_order(windows), key=key, top=top,
                            dropped=dropped, errors=errors,
                            levels=levels_total, paths=paths)

    def _query_history_tree(self, topology, *, key: str | None, top: int,
                            pushdown: bool, **kw) -> "Any":
        """query_history routed through the fleet aggregation tier."""
        import grpc as _grpc

        from ..fleet import flat_summary, fold_tree, parse_topology
        from ..fleet.topology import Topology
        from ..history import (answer_query, decode_frames,
                               dedupe_compacted, level_counts)
        if not isinstance(topology, Topology):
            topology = parse_topology(str(topology), self.targets)
        gadget = kw.get("gadget") or "fleet"

        def fetch_leaf(node: str) -> dict:
            """One leaf's share, reduced to the pushdown reply shape
            (ONE merged window + accounting). Pre-pushdown agents fall
            back to list+fetch and fold client-side to the same shape;
            unreachable agents raise (fold_tree isolates them)."""
            client = self._client(node)
            if pushdown:
                try:
                    return client.query_windows(key=key, **kw)
                except _grpc.RpcError as e:
                    if e.code() != _grpc.StatusCode.UNIMPLEMENTED:
                        raise RuntimeError(
                            f"{e.code().name}: {e.details()}") from e
                    # pre-pushdown agent: fall through to list+fetch
            listing = client.list_windows(key=key, **kw)
            if listing.get("windows"):
                frames, losses = client.fetch_windows(key=key, **kw)
            else:
                frames, losses = [], listing.get("losses") or []
            kept, notes = dedupe_compacted(decode_frames(frames))
            return {"node": node,
                    "window": flat_summary(kept, gadget=gadget, node=node),
                    "folded": True, "levels": level_counts(kept),
                    "torn": 0, "dropped": notes, "losses": losses}

        tf = fold_tree(topology, fetch_leaf, gadget=gadget)
        ans = answer_query(
            [tf.window] if tf.window is not None else [],
            key=key, top=top, dropped=tf.dropped, errors=tf.errors,
            levels=tf.levels, paths=tf.paths)
        # the root window answers as node "fleet"; report the leaves
        # that actually contributed, like the flat fold does
        ans.nodes = [n for n in sorted(tf.paths)
                     if tf.paths.get(n) != "unreachable"]
        ans.fleet = {
            "depth": tf.depth,
            "fan_in": topology.fan_in(),
            "aggregators": len(topology.aggregators()),
            "subtree_folds": tf.subtree_folds,
            "fallback": list(tf.fallback),
            "aggregate": tf.aggregate,
        }
        return ans

    # -- shared-run plane (subscribe-aware fan-out) --------------------------

    def list_runs(self, gadget: str = "") -> tuple[dict, dict]:
        """Per-node live shared-run rows (subscriber counts/classes,
        queue depths, drops, keepalive state) — the attach-by-key
        discovery surface `ig-tpu fleet runs` renders."""
        return self._fanout_unary(
            lambda c: {"runs": c.shared_runs(gadget=gadget)})

    def subscribe_summaries(
        self,
        *,
        gadget: str = "",
        run_id: str = "",
        on_summary: Callable[[str, dict], None] | None = None,
        on_alert: Callable[[str, dict], None] | None = None,
        on_window: Callable[[str, dict], None] | None = None,
        stop_event: threading.Event | None = None,
        priority: str = "low",
        queue: int = 256,
    ) -> dict:
        """The summary pub/sub tier: attach a cheap summary-only
        subscriber to every node's matching shared run — harvest
        summaries, alert transitions, and sealed-window announcements
        from ONE shared harvest, never the raw batches. Blocks until
        stop_event (or every stream ends); returns per-node accounting
        ({node: out-dict}; nodes with no matching run report an error
        entry, never raise)."""
        stop_event = stop_event or threading.Event()
        results: dict[str, dict] = {}
        results_mu = threading.Lock()

        def run_node(node: str):
            client = self._client(node)
            try:
                rid = run_id
                if not rid:
                    rows = client.shared_runs(gadget=gadget)
                    if not rows:
                        raise RuntimeError(
                            f"no live shared run for {gadget or '<any>'!r}")
                    rid = rows[0]["run_id"]
                out = client.run_gadget(
                    "", "", attach_to=rid,
                    subscriber={"tier": "summary", "priority": priority,
                                "queue": int(queue)},
                    on_summary=on_summary, on_alert=on_alert,
                    on_window=on_window, stop_event=stop_event)
            except Exception as e:  # noqa: BLE001 — per-node isolation
                out = {"error": str(e)}
            with results_mu:
                results[node] = out

        threads = [threading.Thread(target=run_node, args=(n,), daemon=True)
                   for n in self.targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def subscribe_query(
        self,
        *,
        query_id: str,
        gadget: str = "",
        run_id: str = "",
        on_answer: Callable[["Any", dict], None] | None = None,
        stop_event: threading.Event | None = None,
        priority: str = "low",
        queue: int = 256,
    ) -> dict:
        """Fleet fan-out for ONE standing query: attach a summary-tier
        subscriber to every node's matching shared run and fold each
        node's materialized answer (EV_QUERY) client-side — the same
        merge algebra QueryWindows replies fold with, so the fleet
        answer is exactly what an ad-hoc fleet query over the same
        coverage would compute. on_answer(answer, meta) fires on every
        node refresh with the latest per-node windows folded;
        meta carries per-node coverage digests and ticks. Blocks until
        stop_event; returns per-node stream accounting."""
        from ..history import answer_query
        from ..history.query import unpack_frames
        from ..history.window import decode_window

        stop_event = stop_event or threading.Event()
        latest: dict[str, tuple[dict, "Any"]] = {}
        latest_mu = threading.Lock()

        def on_query(node: str, qheader: dict, payload: bytes):
            if qheader.get("id") != query_id:
                return
            frames, dropped_bytes = unpack_frames(payload)
            if not frames:
                return
            win = decode_window(*frames[0])
            with latest_mu:
                latest[node] = (qheader, win)
                snap = sorted(latest.items())
            if on_answer is None:
                return
            answer = answer_query(
                [w for _, (_, w) in snap],
                key=(qheader.get("key") or None),
                top=int(qheader.get("top", 20)),
                dropped=([f"{node}: torn answer tail "
                          f"({dropped_bytes} bytes)"]
                         if dropped_bytes else None))
            meta = {
                "id": query_id,
                "from_node": node,
                "nodes": {n: {"tick": h.get("tick", 0),
                              "windows": h.get("windows", 0),
                              "coverage_digest":
                                  h.get("coverage_digest", "")}
                          for n, (h, _) in snap},
            }
            on_answer(answer, meta)

        results: dict[str, dict] = {}
        results_mu = threading.Lock()

        def run_node(node: str):
            client = self._client(node)
            try:
                rid = run_id
                if not rid:
                    rows = client.shared_runs(gadget=gadget)
                    if not rows:
                        raise RuntimeError(
                            f"no live shared run for {gadget or '<any>'!r}")
                    rid = rows[0]["run_id"]
                out = client.run_gadget(
                    "", "", attach_to=rid,
                    subscriber={"tier": "summary", "priority": priority,
                                "queue": int(queue)},
                    on_query=on_query, stop_event=stop_event)
            except Exception as e:  # noqa: BLE001 — per-node isolation
                out = {"error": str(e)}
            with results_mu:
                results[node] = out

        threads = [threading.Thread(target=run_node, args=(n,), daemon=True)
                   for n in self.targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def run_gadget(
        self,
        ctx: GadgetContext,
        *,
        on_event: Callable[[Any], None] | None = None,
        on_event_array: Callable[[list], None] | None = None,
        on_batch: Callable[[Any], None] | None = None,
        on_summary: Callable[[str, dict], None] | None = None,
        on_alert: Callable[[dict], None] | None = None,
    ) -> CombinedGadgetResult:
        # the client runtime mints the trace: one trace ID per gadget run,
        # propagated through every node's RunGadget request so client,
        # agent, operator, and device spans stitch into a single timeline
        with TRACER.span(f"client/run/{ctx.desc.full_name}",
                         parent=ctx.extra.get("trace_ctx"),
                         attrs={"run_id": ctx.run_id,
                                "gadget": ctx.desc.full_name}) as root:
            ctx.extra["trace_ctx"] = root.context
            return self._run_fanout(ctx, root, on_event, on_event_array,
                                    on_batch, on_summary, on_alert)

    def _run_fanout(
        self,
        ctx: GadgetContext,
        root_span,
        on_event: Callable[[Any], None] | None,
        on_event_array: Callable[[list], None] | None,
        on_batch: Callable[[Any], None] | None,
        on_summary: Callable[[str, dict], None] | None,
        on_alert: Callable[[dict], None] | None,
    ) -> CombinedGadgetResult:
        node_filter = ""
        if "node" in ctx.runtime_params:
            node_filter = ctx.runtime_params.get("node").as_string()
        nodes = [n for n in self.targets if not node_filter or n == node_filter]

        flat = ctx.gadget_params.copy_to_map(prefix="gadget.")
        flat.update(ctx.operator_params.copy_to_map())

        cols = ctx.columns
        is_interval = ctx.desc.gadget_type == GadgetType.TRACE_INTERVALS
        is_one_shot = ctx.desc.gadget_type == GadgetType.ONE_SHOT

        outputs = ["json"]
        if on_batch is not None:
            outputs.append("batch")
        if on_summary is not None:
            outputs.append("summary")
        if ctx.extra.get("output") == "json":
            outputs.append("result-json")  # server-side result rendering
        if is_one_shot and on_event_array is not None:
            # ask the agent to stream one-shot rows for client-side combining;
            # without this the agent renders result bytes per node as before
            outputs.append("combiner")

        # cadence derives from the gadget's own interval param, TTL = 2
        # ticks of that interval — the reference's parser.EnableSnapshots
        # (interval, ttl=2) contract (grpc-runtime.go:196-202)
        interval = 1.0
        if is_interval and "interval" in ctx.gadget_params:
            interval = ctx.gadget_params.get("interval").as_duration() or 1.0
        combiner = SnapshotCombiner(ttl_ticks=2) if is_interval else None
        # one-shot: accumulate every node's rows, flush once when all nodes
        # are done (ref: parser.EnableCombiner + Flush, grpc-runtime.go:204-207)
        one_shot_rows: list = []

        results = CombinedGadgetResult()
        results_mu = threading.Lock()
        stop_event = threading.Event()

        # supervision knobs (runtime params with documented defaults)
        supervise = self._rp(ctx, "supervise").as_bool()
        policy = RetryPolicy(
            base=self._rp(ctx, "retry-base").as_duration(),
            cap=max(self._rp(ctx, "retry-cap").as_duration(),
                    self._rp(ctx, "retry-base").as_duration()),
            horizon=self._rp(ctx, "retry-horizon").as_duration(),
            attempt_deadline=self._rp(ctx, "attempt-deadline").as_duration())
        resume_linger = self._rp(ctx, "resume-linger").as_duration()
        resume_ring = self._rp(ctx, "resume-ring").as_int()
        backfill = self._rp(ctx, "backfill").as_bool()
        stop_timeout = self._rp(ctx, "stop-result-timeout").as_duration()
        # shared-run / overload knobs (validated at the params layer —
        # a bad value never reaches the wire)
        share = self._rp(ctx, "share").as_bool()
        run_keepalive = self._rp(ctx, "run-keepalive").as_duration()
        max_subscribers = self._rp(ctx, "max-subscribers").as_int()
        sub_budget = self._rp(ctx, "sub-budget").as_int()
        subscriber_opts = {
            "priority": self._rp(ctx, "priority").as_string(),
            "drop_policy": self._rp(ctx, "drop-policy").as_string(),
            "queue": self._rp(ctx, "sub-queue").as_int(),
            "evict_after": self._rp(ctx, "evict-after").as_duration(),
        }
        health = FleetHealth(
            nodes,
            straggler_factor=self._rp(ctx, "straggler-factor").as_float(),
            straggler_floor=self._rp(ctx, "straggler-floor").as_duration(),
        )
        ctx.extra["fleet_health"] = health  # live view for embedders

        last_msg = {n: time.monotonic() for n in nodes}
        for n in nodes:
            # scrape-time age: keeps growing while the node is silent
            _tm_node_lag.labels(node=n).set_function(
                lambda n=n: time.monotonic() - last_msg[n])

        def _mark(node: str, events: int):
            last_msg[node] = time.monotonic()
            if events:
                _tm_node_events.labels(node=node).inc(events)

        def on_json(node: str, row: dict):
            _mark(node, 1)
            if on_event is not None and cols is not None:
                ev = cols.from_dict(row)
                ev.node = ev.node or node
                on_event(ev)

        def on_array(node: str, rows: list):
            _mark(node, len(rows))
            if cols is None:
                return
            evs = []
            for r in rows:
                ev = cols.from_dict(r)
                ev.node = ev.node or node
                evs.append(ev)
            if combiner is not None:
                combiner.add_snapshot(node, evs)
            elif is_one_shot:
                with results_mu:
                    one_shot_rows.extend(evs)
            elif on_event_array is not None:
                on_event_array(evs)

        # cluster-wide alert dedup: the same rule+key firing on N nodes
        # folds into ONE alert carrying the node list; resolved only when
        # the last node resolves (PSketch's priority-flow fan-in, here at
        # the client tier)
        from ..alerts import ClusterAlertAggregator
        aggregator = ClusterAlertAggregator(on_alert)

        def on_node_alert(node: str, alert: dict):
            _mark(node, 0)
            aggregator.observe(node, alert)

        def on_remote_log(n: str, sev: int, msg: str, header: dict):
            # remote run/trace IDs ride the record as attrs, so the
            # flight recorder can correlate the line with its spans
            from ..utils.logger import std_from_severity
            ctx.logger.log(std_from_severity(sev), "[%s] %s", n, msg,
                           extra={"run_id": header.get("run_id", ""),
                                  "trace_id": header.get("trace_id", "")})

        def run_node(node: str):
            # one child span per node stream; its context rides the run
            # request so the agent's server spans parent to it. The
            # supervisor owns reconnect/resume around the raw stream
            # call; per-node isolation (runtime.go:42-79) is the outer
            # except.
            with TRACER.span(f"client/node/{node}",
                             parent=root_span.context,
                             attrs={"node": node}) as nsp:
                client = self._client(node)
                run_id = f"{ctx.run_id}-{node}"

                def on_msg(_n: str, _seq: int, _t: int, node=node):
                    health.observe(node)

                sup = NodeSupervisor(
                    node, client, policy=policy, health=health,
                    run_id=run_id, gadget=ctx.desc.full_name,
                    done=lambda: ctx.done or stop_event.is_set(),
                    logger=ctx.logger, backfill=backfill)

                def attempt(resume_from, rid, node=node, nsp=nsp):
                    return client.run_gadget(
                        ctx.desc.category, ctx.desc.name, flat,
                        timeout=ctx.timeout, outputs=tuple(outputs),
                        on_json=on_json, on_array=on_array,
                        on_batch=(lambda n, b: on_batch(b)) if on_batch else None,
                        on_summary=on_summary,
                        on_alert=on_node_alert,
                        on_log=on_remote_log,
                        on_message=on_msg,
                        stop_event=stop_event,
                        trace_ctx=nsp.context,
                        run_id=rid,
                        resumable=supervise,
                        linger=resume_linger,
                        ring=resume_ring,
                        resume_from=resume_from,
                        # name WHICH subscriber is reconnecting: without
                        # the acked sub_id a shared run would resolve
                        # the resume onto a peer's stream
                        sub_id=sup.sub_id or None,
                        share=share,
                        keepalive=run_keepalive if share else None,
                        max_subscribers=max_subscribers if share else None,
                        sub_budget=sub_budget if share else None,
                        subscriber=subscriber_opts if share else None,
                    )

                try:
                    if supervise:
                        out = sup.run(attempt)
                    else:
                        out = attempt(None, run_id)
                        if out.get("error"):
                            health.mark(node, "dead")
                    with results_mu:
                        results[node] = GadgetResult(
                            result=out.get("result"),
                            error=out.get("error"),
                            gaps=int(out.get("gaps") or 0),
                            reconnects=int(out.get("reconnects") or 0),
                            records=int(out.get("records") or 0),
                            last_seq=int(out.get("last_seq") or 0),
                            backfilled=int(out.get("backfilled") or 0),
                            backfill=list(out.get("backfill") or ()),
                            health=health.get(node),
                            sub_drops=int(out.get("sub_drops") or 0),
                            evicted=bool(out.get("evicted")),
                            attach_refused=str(
                                out.get("attach_refused") or ""),
                            shared=bool((out.get("attach") or {}).get(
                                "shared")))
                        if out.get("error"):
                            _tm_node_errors.labels(
                                node=node,
                                **{"class": classify_error(
                                    out["error"],
                                    gadget_error=bool(
                                        out.get("gadget_error")))}).inc()
                        if out.get("gaps"):
                            _tm_seq_gaps.labels(node=node).inc(out["gaps"])
                            ctx.logger.warning(
                                "[%s] %d stream message(s) lost in transit "
                                "(%d healed from sealed windows)",
                                node, out["gaps"],
                                int(out.get("backfilled") or 0))
                except Exception as e:  # per-node isolation (runtime.go:42-79)
                    nsp.set_attr("error", str(e))
                    _tm_node_errors.labels(node=node, **{"class": "fatal"}).inc()
                    health.mark(node, "dead")
                    with results_mu:
                        results[node] = GadgetResult(error=str(e),
                                                     health="dead")
                finally:
                    # this node's supervision is over: its final health
                    # label is settled — the straggler monitor must not
                    # re-flag its post-run silence
                    health.finish(node)
                    # stream end reconciles this node's alerts: a dropped
                    # EV_ALERT 'resolved' (or a crashed node) must not
                    # wedge a cluster alert active forever
                    aggregator.node_done(node)

        threads = [threading.Thread(target=run_node, args=(n,), daemon=True)
                   for n in nodes]
        for t in threads:
            t.start()

        ticker_stop = threading.Event()
        if combiner is not None and on_event_array is not None:
            def tick_loop():
                while not ticker_stop.wait(interval):
                    on_event_array(combiner.get_snapshots())

            threading.Thread(target=tick_loop, daemon=True).start()

        # straggler monitor: a node silent for more than
        # straggler-factor × the fleet's rolling inter-record p95 is
        # flagged — slow relative to its PEERS, not to a wall-clock
        # constant (the fleet defines normal cadence). It stops the
        # moment the run starts winding down: silence during shutdown
        # is expected, and flagging it would mislabel a complete
        # answer as partial.
        straggle_stop = threading.Event()

        def straggle_loop():
            while not straggle_stop.wait(0.25):
                for flagged in health.check_stragglers():
                    ctx.logger.warning(
                        "[%s] straggling: silent for %.2fs (fleet p95 "
                        "threshold %.2fs)", flagged,
                        health.silence(flagged),
                        health.straggler_threshold())

        threading.Thread(target=straggle_loop, daemon=True).start()

        # all node streams finishing on their own (one-shot / run-with-result
        # gadgets) also ends the run — don't wait for a timeout that never fires
        def all_done_watch():
            for t in threads:
                t.join()
            ctx.cancel()

        threading.Thread(target=all_done_watch, daemon=True).start()

        # wait: context timeout/cancel then stop-fanout (ref: :336-353)
        ctx.wait_for_timeout_or_done()
        straggle_stop.set()
        stop_event.set()
        # ONE stop window shared by every node (not N× sequential joins:
        # a wide partition at stop time must not scale the wait with
        # fleet size)
        join_deadline = time.monotonic() + stop_timeout
        for t in threads:
            t.join(timeout=max(0.0, join_deadline - time.monotonic()))
        ticker_stop.set()
        # a stream wedged past the stop window must yield a LABELED dead
        # node, not a hang and not a silently missing key
        with results_mu:
            wedged = [n for n in nodes if n not in results]
            for n in wedged:
                results[n] = GadgetResult(
                    error=f"node stream still wedged {stop_timeout:.0f}s "
                          f"after stop fan-out", health="dead")
        for n in wedged:
            health.mark(n, "dead")
        if is_one_shot and on_event_array is not None:
            # flush even when empty so callers still see `[]` / a header,
            # matching the local path
            on_event_array(one_shot_rows)
        # final fleet-health labels ride the combined result so a partial
        # answer is LABELED partial (results.partial), never silently
        # full-looking
        results.health = health.states()
        if results.partial:
            degraded = {n: s for n, s in results.health.items()
                        if s != "healthy"}
            ctx.logger.warning(
                "partial result: %d/%d node(s) contributed (unhealthy: %s)",
                len(results.contributing()), len(nodes), degraded)
        overloaded = results.overloaded()
        if overloaded:
            ctx.logger.warning(
                "subscriber stream(s) degraded under fan-out: %s "
                "(drops are this client's own queue, peers unaffected)",
                overloaded)
        return results
