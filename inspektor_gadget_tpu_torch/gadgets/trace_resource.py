"""Trace resource state machine — the legacy CRD control path.

Reference contract (L9, SURVEY §1/§3.5): a `Trace` custom resource
(pkg/apis/gadget/v1alpha1/types.go:24-140 — spec: node, gadget, filter,
runMode, outputMode; status: state {Started,Stopped,Completed},
operationError, output), driven by annotations carrying the requested
operation; a reconciler on each node (pkg/controllers/trace_controller.go:
100 — node filter, finalizers, operation dispatch) resolves the operation
against a per-gadget TraceFactory
(pkg/gadget-collection/gadgets/interface.go:32-50: Operations() map of
name → {Operation(name, trace)}). `advise` and `traceloop` ride this path
in the reference.

Here the same shapes run against the modern gadget registry: a factory's
start/stop/generate operations drive a background gadget run and park the
result in trace.status.output — no kube API required. The serving surface:
`TraceStore` hosts the reconciler behind the agent's Apply/Get/List/Delete
Trace RPCs (the daemon role of gadget-container/gadgettracermanager/
main.go:262-299), and `TraceWatcher` drives the same store from CR-shaped
documents polled off a kube apiserver, writing status back — the
trace_controller.go reconcile loop without client-go.

The port's copy of ``inspektor_gadget_tpu/gadgets/trace_resource.py``:
the reconciler and the store take a ``device`` (``cuda`` by default)
that every trace's GadgetContext gets; the agent hands them its own.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
from typing import Any

from ..params import Params
from .context import GadgetContext
from .registry import get as get_gadget

STATE_STARTED = "Started"
STATE_STOPPED = "Stopped"
STATE_COMPLETED = "Completed"

OPERATION_ANNOTATION = "gadget.ig-tpu.io/operation"  # ref: annotation key role


@dataclasses.dataclass
class TraceSpec:
    node: str = ""
    gadget: str = ""            # "category/name"
    filter: dict = dataclasses.field(default_factory=dict)
    run_mode: str = "manual"    # ref: RunMode auto|manual
    output_mode: str = "Status"  # ref: OutputMode Status|Stream|File
    parameters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TraceStatus:
    state: str = ""
    operation_error: str = ""
    output: str = ""


@dataclasses.dataclass
class TraceResource:
    name: str
    spec: TraceSpec
    status: TraceStatus = dataclasses.field(default_factory=TraceStatus)
    annotations: dict = dataclasses.field(default_factory=dict)


class TraceRun:
    """One live trace: a gadget running on a thread until stop."""

    def __init__(self, ctx: GadgetContext, thread: threading.Thread,
                 gadget: Any):
        self.ctx = ctx
        self.thread = thread
        self.gadget = gadget


class TraceReconciler:
    """Node-side reconciler (ref: trace_controller.go:100 Reconcile)."""

    def __init__(self, node_name: str = "local", device: str = "cuda"):
        self.node_name = node_name
        self.device = device
        self._runs: dict[str, TraceRun] = {}
        self._mu = threading.Lock()

    def reconcile(self, trace: TraceResource) -> TraceResource:
        # node filter (ref: :172-175) — ignore traces for other nodes
        if trace.spec.node and trace.spec.node != self.node_name:
            return trace
        op = trace.annotations.pop(OPERATION_ANNOTATION, "")
        if not op:
            return trace
        try:
            handler = {
                "start": self._op_start,
                "stop": self._op_stop,
                "generate": self._op_generate,
            }.get(op)
            if handler is None:
                raise ValueError(f"unsupported operation {op!r}")
            handler(trace)
            trace.status.operation_error = ""
        except Exception as e:
            trace.status.operation_error = str(e)
        return trace

    # operations (ref: TraceFactory.Operations() dispatch) ------------------

    def _make_ctx(self, trace: TraceResource) -> tuple[GadgetContext, Any]:
        category, _, name = trace.spec.gadget.partition("/")
        desc = get_gadget(category, name)
        params: Params = desc.params().to_params()
        for k, v in trace.spec.parameters.items():
            if k in params:
                params.set(k, v)
        ctx = GadgetContext(desc, gadget_params=params, device=self.device)
        return ctx, desc

    def _op_start(self, trace: TraceResource) -> None:
        with self._mu:
            if trace.name in self._runs:
                raise ValueError(f"trace {trace.name!r} already started")
        ctx, desc = self._make_ctx(trace)
        gadget = desc.new_instance(ctx)
        target = getattr(gadget, "run", None)
        if hasattr(gadget, "run_with_result"):
            def body():
                try:
                    ctx.result = gadget.run_with_result(ctx)
                except Exception as e:
                    ctx.error = e
        else:
            def body():
                try:
                    target(ctx)
                except Exception as e:
                    ctx.error = e
        t = threading.Thread(target=body, daemon=True)
        t.start()
        with self._mu:
            self._runs[trace.name] = TraceRun(ctx, t, gadget)
        trace.status.state = STATE_STARTED

    def _op_stop(self, trace: TraceResource) -> None:
        with self._mu:
            run = self._runs.pop(trace.name, None)
        if run is None:
            raise ValueError(f"trace {trace.name!r} not running")
        run.ctx.cancel()
        run.thread.join(timeout=10.0)
        trace.status.state = STATE_STOPPED

    def _op_generate(self, trace: TraceResource) -> None:
        """stop-if-needed + surface the gadget's rendered output in status
        (ref: seccomp factory generate → trace.Status.Output, §3.5)."""
        with self._mu:
            run = self._runs.pop(trace.name, None)
        if run is None:
            raise ValueError(f"trace {trace.name!r} not running")
        run.ctx.cancel()
        run.thread.join(timeout=10.0)
        if run.ctx.error is not None:
            raise run.ctx.error
        out = run.ctx.result
        if isinstance(out, bytes):
            out = out.decode("utf-8", "replace")
        trace.status.output = out if isinstance(out, str) else str(out)
        trace.status.state = STATE_COMPLETED

    def active(self) -> list[str]:
        with self._mu:
            return list(self._runs)


# -- CR-shaped document serialization ---------------------------------------
# The wire/API shape mirrors the reference CRD (pkg/apis/gadget/v1alpha1/
# types.go:24-140): apiVersion/kind/metadata{name,annotations}/spec/status.

API_VERSION = "gadget.ig-tpu.io/v1alpha1"
KIND = "Trace"


def trace_to_doc(trace: TraceResource) -> dict:
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": trace.name,
                     "annotations": dict(trace.annotations)},
        "spec": {
            "node": trace.spec.node,
            "gadget": trace.spec.gadget,
            "filter": dict(trace.spec.filter),
            "runMode": trace.spec.run_mode,
            "outputMode": trace.spec.output_mode,
            "parameters": dict(trace.spec.parameters),
        },
        "status": {
            "state": trace.status.state,
            "operationError": trace.status.operation_error,
            "output": trace.status.output,
        },
    }


def trace_from_doc(doc: dict) -> TraceResource:
    meta = doc.get("metadata", {})
    spec = doc.get("spec", {})
    status = doc.get("status", {}) or {}
    return TraceResource(
        name=meta.get("name", ""),
        spec=TraceSpec(
            node=spec.get("node", ""),
            gadget=spec.get("gadget", ""),
            filter=dict(spec.get("filter", {})),
            run_mode=spec.get("runMode", "manual"),
            output_mode=spec.get("outputMode", "Status"),
            parameters=dict(spec.get("parameters", {})),
        ),
        status=TraceStatus(
            state=status.get("state", ""),
            operation_error=status.get("operationError", ""),
            output=status.get("output", ""),
        ),
        annotations=dict(meta.get("annotations", {})),
    )


class TraceStore:
    """Agent-side Trace registry: documents in, reconciled documents out.

    The daemon-hosted half of the L9 path (ref: main.go:262-299 starts the
    CRD controller in the node daemon): `apply` is one reconcile —
    annotation-driven operation dispatch against the live registry — and
    the store keeps the resulting resource so later operations (stop,
    generate) find the running trace.
    """

    def __init__(self, node_name: str = "local", device: str = "cuda"):
        self.reconciler = TraceReconciler(node_name=node_name, device=device)
        self._traces: dict[str, TraceResource] = {}
        self._mu = threading.Lock()
        # applies are serialized end to end (lookup → reconcile → store):
        # concurrent RPC workers racing the same name must not interleave,
        # or a losing 'already started' apply overwrites the winner's
        # Started record. Reads (get/list) stay on the cheap _mu only.
        self._apply_mu = threading.Lock()

    def apply(self, doc: dict) -> dict:
        with self._apply_mu:
            return self._apply_locked(doc)

    def _apply_locked(self, doc: dict) -> dict:
        incoming = trace_from_doc(doc)
        if not incoming.name:
            raise ValueError("trace document has no metadata.name")
        # node filter before any store: a trace pinned elsewhere must not
        # become an inert local resource with a forever-pending annotation
        if (incoming.spec.node
                and incoming.spec.node != self.reconciler.node_name):
            return trace_to_doc(incoming)
        with self._mu:
            stored = self._traces.get(incoming.name)
            # reconcile works on a private COPY and the store is only
            # updated (swapped whole) after reconcile completes: mutating
            # the stored resource in place would let a concurrent
            # get()/list() observe the updated spec with stale status
            # (torn read — spec and status must always be one consistent
            # generation)
            existing = copy.deepcopy(stored)
        if existing is not None:
            if incoming.spec.gadget and incoming.spec != existing.spec:
                # a spec update is only safe while nothing runs against the
                # old one; reject loudly rather than silently keeping it
                if existing.name in self.reconciler.active():
                    existing.status.operation_error = (
                        "spec update rejected: trace is running (stop first)")
                    # consume the operation annotation: this branch skips
                    # reconcile (which normally pops it), and a writeback
                    # with it intact would re-fire the rejected op forever
                    existing.annotations.update(incoming.annotations)
                    existing.annotations.pop(OPERATION_ANNOTATION, None)
                    with self._mu:
                        self._traces[existing.name] = existing
                    return trace_to_doc(existing)
                existing.spec = incoming.spec
            # operations arrive as annotations on the stored resource
            # (trace_controller.go:100)
            existing.annotations.update(incoming.annotations)
            trace = existing
        else:
            trace = incoming
        self.reconciler.reconcile(trace)
        with self._mu:
            # an operation aimed at a name that was never created is an
            # error reply, not a new phantom resource
            if existing is not None or trace.spec.gadget:
                self._traces[trace.name] = trace
        return trace_to_doc(trace)

    def get(self, name: str) -> dict | None:
        with self._mu:
            trace = self._traces.get(name)
        return trace_to_doc(trace) if trace is not None else None

    def list(self) -> list[dict]:
        with self._mu:
            return [trace_to_doc(t) for t in self._traces.values()]

    def delete(self, name: str) -> bool:
        """Finalizer semantics (ref: trace_controller.go finalizers): a
        still-running trace is stopped before the resource goes away."""
        with self._apply_mu:
            with self._mu:
                trace = self._traces.pop(name, None)
            if trace is None:
                return False
            if trace.name in self.reconciler.active():
                trace.annotations[OPERATION_ANNOTATION] = "stop"
                self.reconciler.reconcile(trace)
            return True


class TraceWatcher:
    """Kube-API-fed reconcile loop (ref: trace_controller.go:100 under
    controller-runtime; here a poll-diff loop over the CR REST path).

    Polls `<base>/traces` off a KubeClient-shaped object (`get(path)` +
    `send(path, body, method)`), feeds every document carrying the
    operation annotation into a TraceStore, and writes the reconciled
    status (and cleared annotation) back with a PUT — the status-update
    half of the reconcile contract the CLI's waitForCondition watches
    (cmd/kubectl-gadget/utils/trace.go:513).
    """

    BASE = "/apis/gadget.ig-tpu.io/v1alpha1"

    def __init__(self, client: Any, store: TraceStore,
                 namespace: str = "ig-tpu", interval: float = 1.0):
        self.client = client
        self.store = store
        self.namespace = namespace
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _path(self, name: str = "") -> str:
        p = f"{self.BASE}/namespaces/{self.namespace}/traces"
        return f"{p}/{name}" if name else p

    def poll_once(self) -> int:
        """One list+reconcile+writeback cycle; returns #operations served.
        Apiserver blips leave local state untouched (informer resync
        stance, same as the pod informer)."""
        try:
            items = self.client.get(self._path()).get("items", [])
        except Exception:
            return 0
        served = 0
        for doc in items:
            annotations = doc.get("metadata", {}).get("annotations", {})
            if OPERATION_ANNOTATION not in annotations:
                continue
            consumed_op = annotations[OPERATION_ANNOTATION]
            node = doc.get("spec", {}).get("node", "")
            if node and node != self.store.reconciler.node_name:
                continue  # node filter (ref: :172-175)
            name = doc.get("metadata", {}).get("name", "")
            try:
                applied = self.store.apply(doc)
                status = applied.get("status", {})
                new_annotations = applied["metadata"]["annotations"]
            except Exception as e:
                status = {**(doc.get("status") or {}),
                          "operationError": str(e)}
                new_annotations = {k: v for k, v in annotations.items()
                                   if k != OPERATION_ANNOTATION}
            # write back onto the POLLED doc: apiserver updates need the
            # original metadata (resourceVersion, namespace, labels, ...)
            # intact or the PUT is rejected and the annotation re-fires
            updated = {**doc,
                       "metadata": {**doc.get("metadata", {}),
                                    "annotations": new_annotations},
                       "status": status}
            if self._write_back(name, updated, new_annotations, status,
                                consumed_op):
                served += 1
        return served

    WRITE_RETRIES = 3  # conflict retries before giving up on one cycle

    def _write_back(self, name: str, updated: dict, annotations: dict,
                    status: dict, consumed_op: str = "") -> bool:
        """PUT the reconciled doc back, surviving the two apiserver
        rejections a live reconciler actually meets (VERDICT #9):

        - 409 resourceVersion conflict (someone updated the resource
          between our list and our PUT): re-GET the fresh document,
          re-apply OUR annotations + status onto ITS metadata (picking up
          the new resourceVersion), and retry — never drop the writeback,
          or the consumed operation annotation re-fires forever.
        - status-subresource rejection (409/422 naming the status
          subresource): write the main resource without status, then PUT
          the status to `<path>/status` — the Status().Update split the
          real controller performs.
        """
        log = logging.getLogger("ig-tpu.tracewatcher")
        doc = updated
        for attempt in range(1 + self.WRITE_RETRIES):
            try:
                self.client.send(self._path(name), doc, method="PUT")
                return True
            except Exception as e:  # noqa: BLE001 — classified below
                code = getattr(e, "code", 0)
                detail = self._http_detail(e)
                if code == 422 and "status" in detail.lower():
                    return self._write_split(name, doc, status, log,
                                             annotations, consumed_op)
                if code != 409 or attempt == self.WRITE_RETRIES:
                    log.warning("status writeback for %s failed: %s",
                                name, e)
                    return False
                # conflict: re-poll the resource and graft our update onto
                # its current metadata (fresh resourceVersion). The fresh
                # annotations WIN over our stale snapshot — the concurrent
                # writer may have added keys (even a NEW operation, which
                # must survive to be served next poll); we only strip the
                # operation annotation when it is still the one we just
                # consumed.
                try:
                    fresh = self.client.get(self._path(name))
                except Exception as ge:  # noqa: BLE001 — retry loop logs
                    log.warning("conflict re-poll for %s failed: %s",
                                name, ge)
                    return False
                doc = self._graft(fresh, annotations, consumed_op,
                                  status=status)
                log.debug("writeback conflict for %s; retrying with "
                          "resourceVersion %s", name,
                          doc["metadata"].get("resourceVersion"))
        return False

    @staticmethod
    def _graft(fresh: dict, annotations: dict, consumed_op: str,
               status: dict | None) -> dict:
        """Build a retry document on top of the freshly-GET resource: the
        fresh annotations WIN over our stale snapshot (a concurrent
        writer may have added keys, even a NEW operation which must
        survive to be served next poll); only the operation annotation we
        just consumed is stripped. status=None omits status entirely (the
        status-subresource main-resource half)."""
        fresh_ann = dict(fresh.get("metadata", {}).get("annotations") or {})
        if fresh_ann.get(OPERATION_ANNOTATION) == consumed_op:
            fresh_ann.pop(OPERATION_ANNOTATION, None)
        out = {**fresh,
               "metadata": {**fresh.get("metadata", {}),
                            "annotations": {**annotations, **fresh_ann}}}
        if status is None:
            out.pop("status", None)
        else:
            out["status"] = status
        return out

    def _write_split(self, name: str, doc: dict, status: dict, log,
                     annotations: dict, consumed_op: str) -> bool:
        """Status-subresource path: PUT the status to <path>/status FIRST,
        then the main resource (which consumes the operation annotation).
        Status-first matters: the main PUT is the irreversible half — if
        it ran first and the status PUT then failed, the annotation would
        already be consumed and no later poll would retry, stranding the
        resource on its stale status forever. This order fails towards
        at-least-once: a failed main PUT leaves the annotation in place
        and the next cycle re-reconciles.

        The /status write bumps resourceVersion on a real apiserver, so
        the follow-up main PUT re-polls on 409 instead of giving up —
        otherwise the annotation would re-fire the operation every poll
        forever."""
        main = {k: v for k, v in doc.items() if k != "status"}
        try:
            self.client.send(self._path(name) + "/status",
                             {**main, "status": status}, method="PUT")
        except Exception as e:  # noqa: BLE001 — keep reconciling others
            log.warning("status-subresource writeback for %s failed: %s",
                        name, e)
            return False
        for attempt in range(1 + self.WRITE_RETRIES):
            try:
                self.client.send(self._path(name), main, method="PUT")
                return True
            except Exception as e:  # noqa: BLE001 — classified below
                if (getattr(e, "code", 0) != 409
                        or attempt == self.WRITE_RETRIES):
                    log.warning("status-subresource main writeback for "
                                "%s failed: %s", name, e)
                    return False
                try:
                    fresh = self.client.get(self._path(name))
                except Exception as ge:  # noqa: BLE001 — retry loop logs
                    log.warning("conflict re-poll for %s failed: %s",
                                name, ge)
                    return False
                main = self._graft(fresh, annotations, consumed_op,
                                   status=None)
        return False

    @staticmethod
    def _http_detail(e: Exception) -> str:
        """Best-effort rejection reason off an HTTPError body (consumed
        once here — urllib bodies are read-once streams)."""
        read = getattr(e, "read", None)
        if callable(read):
            try:
                return read().decode("utf-8", "replace")
            except (OSError, ValueError):
                return str(e)
        return str(e)

    def start(self) -> None:
        if self._thread:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — the loop must survive
                    logging.getLogger("ig-tpu.tracewatcher").debug(
                        "poll failed: %r", e)
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="trace-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None
