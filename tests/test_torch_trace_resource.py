"""The port's legacy CRD path (model: pkg/controllers/trace_controller_test.go
under envtest): the cases of ``tests/test_trace_resource.py`` against
``inspektor_gadget_tpu_torch.gadgets.trace_resource`` with the reconciler
on the CPU, plus the store's device and the kube controller's writeback."""

import json
import time

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.gadgets.trace_resource import (
    OPERATION_ANNOTATION,
    STATE_COMPLETED,
    STATE_STARTED,
    STATE_STOPPED,
    TraceReconciler,
    TraceResource,
    TraceSpec,
    TraceStore,
    TraceWatcher,
)


def make_trace(name="t1", gadget="advise/seccomp-profile", node=""):
    return TraceResource(
        name=name,
        spec=TraceSpec(node=node, gadget=gadget,
                       parameters={"source": "pysynthetic", "rate": "20000"}),
    )


def test_start_generate_lifecycle():
    r = TraceReconciler(node_name="node-a", device="cpu")
    tr = make_trace()
    tr.annotations[OPERATION_ANNOTATION] = "start"
    r.reconcile(tr)
    assert tr.status.state == STATE_STARTED and not tr.status.operation_error
    assert r.active() == ["t1"]
    time.sleep(0.5)
    tr.annotations[OPERATION_ANNOTATION] = "generate"
    r.reconcile(tr)
    assert tr.status.state == STATE_COMPLETED, tr.status.operation_error
    profiles = json.loads(tr.status.output)
    assert profiles and "defaultAction" in next(iter(profiles.values()))
    assert r.active() == []


def test_stop_operation():
    r = TraceReconciler(device="cpu")
    tr = make_trace(name="t2", gadget="trace/exec")
    tr.annotations[OPERATION_ANNOTATION] = "start"
    r.reconcile(tr)
    assert tr.status.state == STATE_STARTED
    tr.annotations[OPERATION_ANNOTATION] = "stop"
    r.reconcile(tr)
    assert tr.status.state == STATE_STOPPED


def test_node_filter_ignores_foreign_traces():
    r = TraceReconciler(node_name="node-a", device="cpu")
    tr = make_trace(name="t3", node="node-b")
    tr.annotations[OPERATION_ANNOTATION] = "start"
    r.reconcile(tr)
    assert tr.status.state == ""  # untouched
    assert r.active() == []


def test_bad_operation_reports_error():
    r = TraceReconciler(device="cpu")
    tr = make_trace(name="t4")
    tr.annotations[OPERATION_ANNOTATION] = "explode"
    r.reconcile(tr)
    assert "unsupported operation" in tr.status.operation_error


def test_double_start_rejected():
    r = TraceReconciler(device="cpu")
    tr = make_trace(name="t5", gadget="trace/exec")
    tr.annotations[OPERATION_ANNOTATION] = "start"
    r.reconcile(tr)
    tr.annotations[OPERATION_ANNOTATION] = "start"
    r.reconcile(tr)
    assert "already started" in tr.status.operation_error
    tr.annotations[OPERATION_ANNOTATION] = "stop"
    r.reconcile(tr)


def test_store_gives_every_trace_its_device():
    store = TraceStore(node_name="node-a", device="cpu")
    doc = {"metadata": {"name": "t6", "annotations": {OPERATION_ANNOTATION: "start"}},
           "spec": {"gadget": "trace/exec",
                    "parameters": {"source": "pysynthetic", "rate": "20000"}}}
    out = store.apply(doc)
    assert out["status"]["state"] == STATE_STARTED, out["status"]
    run = store.reconciler._runs["t6"]
    assert run.ctx.device == "cpu"
    assert store.delete("t6") and store.reconciler.active() == []
    # the default is the card, as every entry point of the port
    assert TraceStore().reconciler.device == "cuda"


class _FakeKube:
    """A KubeClient-shaped apiserver holding one trace list."""

    def __init__(self, items):
        self.items = items
        self.puts = []

    def get(self, path):
        return {"items": self.items}

    def send(self, path, body, method="GET"):
        self.puts.append((path, body))
        return body


def test_watcher_serves_and_writes_back():
    store = TraceStore(node_name="node-a", device="cpu")
    kube = _FakeKube([
        {"metadata": {"name": "w1", "resourceVersion": "7",
                      "annotations": {OPERATION_ANNOTATION: "start"}},
         "spec": {"gadget": "trace/exec",
                  "parameters": {"source": "pysynthetic", "rate": "20000"}}},
        {"metadata": {"name": "w2", "annotations": {OPERATION_ANNOTATION: "start"}},
         "spec": {"node": "node-b", "gadget": "trace/exec"}},
        {"metadata": {"name": "w3", "annotations": {}}, "spec": {"gadget": "trace/exec"}}])
    watcher = TraceWatcher(kube, store, namespace="ns")
    assert watcher.poll_once() == 1
    (path, body), = kube.puts
    assert path.endswith("/namespaces/ns/traces/w1")
    assert body["status"]["state"] == STATE_STARTED
    assert body["metadata"]["resourceVersion"] == "7"
    assert OPERATION_ANNOTATION not in body["metadata"]["annotations"]
    assert store.delete("w1") and store.reconciler.active() == []
