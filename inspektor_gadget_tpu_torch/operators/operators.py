"""Operator registry, dependency toposort, and lifecycle plumbing.

Reference contract (pkg/operators/operators.go):
  Operator{Name, Dependencies, GlobalParamDescs, ParamDescs, CanOperateOn,
           Init, Instantiate} :40-75
  OperatorInstance{Name, PreGadgetRun, PostGadgetRun, EnrichEvent} :77-85
  Register :137, GetOperatorsForGadget :164, SortOperators (Kahn) :269-348,
  OperatorInstances.Enrich :257.

Beyond the reference's contract, instances may implement enrich_batch(EventBatch) for the
columnar hot path; the per-event enrich() remains for the formatter path.

The port's copy of ``inspektor_gadget_tpu/operators/operators.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..params import Collection, ParamDescs, Params
from ..telemetry import counter, histogram
from ..telemetry.tracing import TRACER

# chain telemetry: batch-grain only (the per-event enrich() path stays
# uninstrumented — at millions of rows/sec even a perf_counter pair would
# be measurable; batches carry thousands of events each)
_enrich_seconds = histogram(
    "ig_operator_enrich_seconds",
    "per-operator enrich_batch latency", ("operator",))
_gadget_events = counter(
    "ig_gadget_events_total",
    "events through each gadget's operator chain", ("gadget",))


class Operator:
    name: str = ""

    def dependencies(self) -> list[str]:
        return []

    def global_params(self) -> ParamDescs:
        return ParamDescs()

    def instance_params(self) -> ParamDescs:
        return ParamDescs()

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        return True

    def init(self, global_params: Params) -> None:
        pass

    def close(self) -> None:
        pass

    def instantiate(
        self, ctx: GadgetContext, gadget: Any, instance_params: Params
    ) -> "OperatorInstance":
        raise NotImplementedError


class OperatorInstance:
    def __init__(self, name: str):
        self.name = name

    def pre_gadget_run(self) -> None:
        pass

    def post_gadget_run(self) -> None:
        pass

    def enrich(self, event: Any) -> None:
        pass

    def enrich_batch(self, batch: Any) -> None:
        pass


class Operators(list):
    """Ordered list of OperatorInstance with the enrich chain."""

    def pre_gadget_run(self) -> None:
        started = []
        try:
            for inst in self:
                inst.pre_gadget_run()
                started.append(inst)
        except Exception:
            for inst in reversed(started):
                inst.post_gadget_run()
            raise

    def post_gadget_run(self) -> None:
        for inst in reversed(self):
            inst.post_gadget_run()

    def enrich(self, event: Any) -> Any:
        for inst in self:
            inst.enrich(event)
        return event

    def _spans(self) -> list[tuple[Any, Any]]:
        spans = getattr(self, "_tm_spans", None)
        if spans is None or len(spans) != len(self):
            spans = [(inst, _enrich_seconds.labels(operator=inst.name))
                     for inst in self]
            self._tm_spans = spans
        return spans

    def enrich_batch(self, batch: Any) -> Any:
        # batch-grain child spans (parented to the run span) upgrade the
        # bare histogram timers: the histogram keeps the aggregate, the
        # span places THIS batch's enrich on the run's timeline
        parent = getattr(self, "trace_parent", None)
        n = batch.count
        for inst, hist in self._spans():
            with TRACER.span(f"op/{inst.name}", parent=parent,
                             attrs={"events": n}):
                t0 = time.perf_counter()
                inst.enrich_batch(batch)
                hist.observe(time.perf_counter() - t0)
        events = getattr(self, "gadget_events", None)
        if events is not None and n:
            events.inc(n)
        return batch


_REGISTRY: dict[str, Operator] = {}
_initialized: set[str] = set()
_init_lock = threading.Lock()


def register(op: Operator) -> Operator:
    if op.name in _REGISTRY:
        raise ValueError(f"operator {op.name!r} already registered")
    _REGISTRY[op.name] = op
    return op


def get(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown operator {name!r}") from None


def get_all() -> list[Operator]:
    return list(_REGISTRY.values())


def ensure_initialized(name: str) -> Operator:
    """Get an operator, running its one-time init if it hasn't yet
    (ref: operators.go:117-127 init-once sync.Once). Marks the operator in
    the same _initialized set install_operators consults, so a later gadget
    run won't re-init and replace its state (e.g. localmanager's container
    collection — anything attached to it, like a pod informer, would be
    orphaned by a second init). Thread-safe: gRPC handler threads and the
    daemon main thread may race here."""
    op = get(name)
    with _init_lock:
        if name not in _initialized:
            op.init(op.global_params().to_params())
            _initialized.add(name)
    return op


def clear() -> None:
    _REGISTRY.clear()
    _initialized.clear()


def get_operators_for_gadget(desc: GadgetDesc) -> list[Operator]:
    """All registered operators that CanOperateOn the gadget, plus their
    transitive dependencies, sorted (ref: operators.go:164-200)."""
    chosen: dict[str, Operator] = {}

    def add(op: Operator):
        if op.name in chosen:
            return
        chosen[op.name] = op
        for dep in op.dependencies():
            add(get(dep))

    for op in _REGISTRY.values():
        if op.can_operate_on(desc):
            add(op)
    return sort_operators(list(chosen.values()))


def sort_operators(ops: list[Operator]) -> list[Operator]:
    """Kahn's algorithm over the dependency graph (ref: operators.go:269-348).
    Raises on cycles and on missing dependencies."""
    by_name = {op.name: op for op in ops}
    indeg = {n: 0 for n in by_name}
    edges: dict[str, list[str]] = {n: [] for n in by_name}
    for op in ops:
        for dep in op.dependencies():
            if dep not in by_name:
                raise ValueError(
                    f"operator {op.name!r} depends on unregistered {dep!r}"
                )
            edges[dep].append(op.name)
            indeg[op.name] += 1
    queue = sorted(n for n, d in indeg.items() if d == 0)
    out: list[Operator] = []
    while queue:
        n = queue.pop(0)
        out.append(by_name[n])
        for m in edges[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                queue.append(m)
        queue.sort()
    if len(out) != len(ops):
        cyc = sorted(set(by_name) - {o.name for o in out})
        raise ValueError(f"operator dependency cycle involving {cyc}")
    return out


def install_operators(
    ctx: GadgetContext, gadget: Any,
    params_by_operator: Collection | None = None,
    operators: list[Operator] | None = None,
) -> Operators:
    """Init (once) + instantiate the operator chain for one run
    (ref: runtime/local/local.go:100-133 install sequence)."""
    ops = operators if operators is not None else get_operators_for_gadget(ctx.desc)
    instances = Operators()
    instances.gadget_events = _gadget_events.labels(gadget=ctx.desc.full_name)
    # the run span context (set by the runtime before install): enrich
    # spans parent to it even from source/drain threads, where the
    # tracer's contextvar is empty
    instances.trace_parent = ctx.extra.get("trace_ctx")
    for op in ops:
        with _init_lock:
            if op.name not in _initialized:
                op.init(op.global_params().to_params())
                _initialized.add(op.name)
        prefix = f"operator.{op.name}."
        iparams = None
        if params_by_operator is not None and prefix in params_by_operator:
            iparams = params_by_operator[prefix]
        if iparams is None:
            iparams = op.instance_params().to_params()
        instances.append(op.instantiate(ctx, gadget, iparams))
    return instances
