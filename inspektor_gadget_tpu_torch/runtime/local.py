"""Local runtime: instantiate → install operators → wire handlers → run.

Reference contract: pkg/runtime/local/local.go:69-152 —
  NewInstance (:84) → operators.Instantiate (:100) →
  SetEventHandler(enrich-then-callback) (:108-110) →
  operatorInstances.PreGadgetRun (:126) → Run / RunWithResult (:133-146) →
  PostGadgetRun. Event flow per §3.1: source → enrich chain → parser
  callback → formatter.

The batch path is first-class — gadgets that emit EventBatches
get them enriched (enrich_batch) and forwarded to a batch callback; per-row
callbacks remain for display/JSON.

The port's copy of ``inspektor_gadget_tpu/runtime/local.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ..gadgets.context import GadgetContext
from ..gadgets.interface import (
    EventHandlerArraySetter,
    BatchHandlerSetter,
    EventHandlerSetter,
    RunWithResult,
)
from ..operators.operators import install_operators
from .runtime import CombinedGadgetResult, GadgetResult, Runtime


class LocalRuntime(Runtime):
    name = "local"

    def __init__(self, node_name: str = "local"):
        self.node_name = node_name

    def run_gadget(
        self,
        ctx: GadgetContext,
        *,
        on_event: Callable[[Any], None] | None = None,
        on_event_array: Callable[[list], None] | None = None,
        on_batch: Callable[[Any], None] | None = None,
    ) -> CombinedGadgetResult:
        result = CombinedGadgetResult()
        try:
            res = self._run(ctx, on_event, on_event_array, on_batch)
            result[self.node_name] = GadgetResult(result=res)
        except Exception as e:  # per-node error isolation (runtime.go:42-79)
            ctx.logger.exception("gadget run failed")
            result[self.node_name] = GadgetResult(error=str(e))
        return result

    def _run(self, ctx, on_event, on_event_array, on_batch):
        from ..telemetry.tracing import TRACER
        # one span per local run: child of the agent's run span when this
        # runtime serves a gRPC request (ctx.extra carries the context),
        # a fresh trace for a standalone `ig-tpu <gadget>` run
        with TRACER.span(f"run/{ctx.desc.full_name}",
                         parent=ctx.extra.get("trace_ctx"),
                         attrs={"run_id": ctx.run_id,
                                "node": self.node_name}) as span:
            ctx.extra["trace_ctx"] = span.context
            # node identity for operators that stamp events (alerts)
            ctx.extra.setdefault("node", self.node_name)
            return self._run_traced(ctx, on_event, on_event_array, on_batch)

    def _run_traced(self, ctx, on_event, on_event_array, on_batch):
        gadget = ctx.desc.new_instance(ctx)
        from ..gadgets.interface import GadgetType
        if (ctx.desc.gadget_type in (GadgetType.PROFILE,
                                     GadgetType.START_STOP)
                and not isinstance(gadget, RunWithResult)):
            # a result-typed gadget without run_with_result would fall
            # through to run() and the caller would wait on a result
            # that never comes — fail loudly at wiring time instead
            raise TypeError(
                f"{ctx.desc.full_name} is registered as "
                f"{ctx.desc.gadget_type.value} but its gadget class "
                f"{type(gadget).__name__} does not implement "
                f"run_with_result")
        instances = install_operators(ctx, gadget, ctx.operator_params)

        if on_event is not None and isinstance(gadget, EventHandlerSetter):
            def handle(ev):
                instances.enrich(ev)
                on_event(ev)
            gadget.set_event_handler(handle)

        if on_event_array is not None and isinstance(gadget, EventHandlerArraySetter):
            def handle_array(evs):
                for ev in evs:
                    instances.enrich(ev)
                on_event_array(evs)
            gadget.set_event_handler_array(handle_array)

        if isinstance(gadget, BatchHandlerSetter):
            def handle_batch(batch):
                instances.enrich_batch(batch)
                if on_batch is not None:
                    on_batch(batch)
            gadget.set_batch_handler(handle_batch)

        if ctx.timeout > 0:
            import threading
            threading.Thread(
                target=ctx.wait_for_timeout_or_done, daemon=True
            ).start()

        instances.pre_gadget_run()
        try:
            if isinstance(gadget, RunWithResult):
                # the gadget collects until ctx timeout/cancel, then renders
                ctx.result = gadget.run_with_result(ctx)
            else:
                gadget.run(ctx)
        finally:
            instances.post_gadget_run()
        return ctx.result
