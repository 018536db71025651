"""LocalManager operator: container filtering + enrichment for local runs.

Reference contract: pkg/operators/localmanager/localmanager.go —
CanOperateOn :93-121 (gadget wants a mntns map or is an Attacher),
Instantiate :173, PreGadgetRun :208 (create per-run tracer in the
TracerCollection, inject the mntns filter, attach containers for Attacher
gadgets, subscribe for runtime add/remove). Instance params: containername/
host filtering (params mirrored from localmanager gadget params).

The port's copy of ``inspektor_gadget_tpu/operators/localmanager.py``.
"""

from __future__ import annotations

from typing import Any

from ..containers import (
    Container,
    ContainerCollection,
    ContainerSelector,
    EventType,
    TracerCollection,
    with_linux_namespace_enrichment,
    with_node_name,
    with_procfs_discovery,
)
from ..gadgets.context import GadgetContext
from ..gadgets.interface import Attacher, GadgetDesc, MountNsFilterSetter
from ..params import ParamDesc, ParamDescs, Params, TypeHint
from .operators import Operator, OperatorInstance, register


class LocalManager(Operator):
    name = "localmanager"

    def __init__(self):
        self.cc: ContainerCollection | None = None
        self.tc: TracerCollection | None = None

    def global_params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="containerd-like-discovery", default="procfs",
                      description="container discovery backend",
                      possible_values=("procfs", "none")),
            ParamDesc(key="node-name", default="local"),
        ])

    def instance_params(self) -> ParamDescs:
        # ref: localmanager.go instance params containername/host
        return ParamDescs([
            ParamDesc(key="containername", default="",
                      description="filter events by container name"),
            ParamDesc(key="host", default="false", type_hint=TypeHint.BOOL,
                      description="include host (non-container) events"),
        ])

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        # ref: localmanager.go:93-121 — applies when the gadget can take a
        # mntns filter or attaches per container; cheap to apply broadly for
        # enrichment, so also cover event-emitting gadgets.
        return True

    def init(self, global_params: Params) -> None:
        from ..containers import (
            with_oci_config_enrichment, with_runtime_enrichment,
        )
        self.cc = ContainerCollection()
        opts = [with_node_name(global_params.get("node-name").as_string()
                               if "node-name" in global_params else "local")]
        # runtime auto-chain first (completes hook-shaped adds with
        # pid/name from docker/containerd/CRI — options.go:132-197), then
        # OCI-config enrichment (mounts/env/annotations from the bundle),
        # then namespace resolution; all silently degrade when absent
        opts.append(with_runtime_enrichment())
        opts.append(with_oci_config_enrichment())
        if ("containerd-like-discovery" in global_params
                and global_params.get("containerd-like-discovery").as_string() == "procfs"):
            opts.append(with_linux_namespace_enrichment())
            opts.append(with_procfs_discovery())
        self.cc.initialize(*opts)
        self.tc = TracerCollection(self.cc)

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "LocalManagerInstance":
        return LocalManagerInstance(self, ctx, gadget, instance_params)


class LocalManagerInstance(OperatorInstance):
    def __init__(self, op: LocalManager, ctx: GadgetContext, gadget: Any,
                 params: Params):
        super().__init__(op.name)
        self.op = op
        self.ctx = ctx
        self.gadget = gadget
        cname = params.get("containername").as_string() if "containername" in params else ""
        self.selector = ContainerSelector(name=cname)
        self.host = params.get("host").as_bool() if "host" in params else False
        self._tracer_id = f"{ctx.run_id}"
        self._attached: list[Container] = []
        self._mark_selector_active()

    def _selector_set(self) -> bool:
        return bool(self.selector.name or self.selector.pod
                    or self.selector.namespace
                    or getattr(self.selector, "labels", None))

    def _mark_selector_active(self) -> None:
        """Both manager flavours (local + kube) run on every gadget; when
        ONE of them carries a user selector, the other must not attach-all
        (its empty selector would capture every container and defeat the
        scoping — the black-box negative test's leak)."""
        if self._selector_set():
            self.ctx.extra["container_selector_active"] = True

    def pre_gadget_run(self) -> None:
        op = self.op
        if op.tc is None:
            return
        if (not self._selector_set()
                and self.ctx.extra.get("container_selector_active")):
            return  # the scoped manager instance owns this run
        # ref: localmanager.go:208-228 — register tracer, inject filter
        op.tc.add_tracer(self._tracer_id, self.selector)
        if isinstance(self.gadget, MountNsFilterSetter):
            # filter only when a container selector is active; a bare local
            # run traces everything including host (ref: localmanager.go
            # host/containername param semantics)
            if self._selector_set():
                self.gadget.set_mntns_filter(
                    op.tc.tracer_mntns_set(self._tracer_id))
        if isinstance(self.gadget, Attacher) and self._attach_enabled():
            # tell the gadget attaches are coming (possibly later — the
            # selector may match a container that doesn't exist yet), so it
            # must wait rather than fail "no target" at startup
            if hasattr(type(self.gadget), "attach_pending"):
                self.gadget.attach_pending = True
            for c in op.cc.get_all(self.selector):
                try:
                    self.gadget.attach_container(c)
                    self._attached.append(c)
                except Exception as e:  # attach best-effort per container
                    self.ctx.logger.warning("attach %s failed: %s", c.name, e)
            op.cc.subscribe(self, self._on_container_event)

    def post_gadget_run(self) -> None:
        op = self.op
        if op.cc is not None:
            op.cc.unsubscribe(self)
        if op.tc is not None:
            op.tc.remove_tracer(self._tracer_id)
        if isinstance(self.gadget, Attacher):
            for c in self._attached:
                try:
                    self.gadget.detach_container(c)
                except Exception as e:  # noqa: BLE001 — detach the rest
                    self.ctx.logger.debug("detach on teardown failed: %r", e)
            self._attached.clear()

    def _attach_enabled(self) -> bool:
        """Heavy per-container attaches (the ptrace stream) only run when
        the user scoped the gadget with a container selector — attaching to
        every procfs-discovered process would ptrace the whole host. Light
        attachers (traceloop rings, netns sockets) opt out of the gate via
        attach_requires_selector=False."""
        # an explicitly synthetic run must never interleave real capture
        # rows (they'd hit the synthetic decode branch as garbage)
        if getattr(self.gadget, "_mode", "auto") not in ("auto", "native"):
            return False
        if not getattr(self.gadget, "attach_requires_selector", False):
            return True
        return self._selector_set()

    def _on_container_event(self, ev) -> None:
        if not self.selector.matches(ev.container):
            return
        if isinstance(self.gadget, MountNsFilterSetter):
            try:
                self.gadget.set_mntns_filter(
                    self.op.tc.tracer_mntns_set(self._tracer_id))
            except KeyError:
                pass
        if isinstance(self.gadget, Attacher) and self._attach_enabled():
            if ev.type == EventType.ADD:
                try:
                    self.gadget.attach_container(ev.container)
                    self._attached.append(ev.container)
                except Exception as e:
                    self.ctx.logger.warning("attach failed: %s", e)
            else:
                try:
                    self.gadget.detach_container(ev.container)
                except Exception as e:  # noqa: BLE001 — container already gone
                    self.ctx.logger.debug("detach failed: %r", e)

    def enrich(self, event: Any) -> None:
        if self.op.cc is not None:
            self.op.cc.enrich_event_by_mntns(event)

    def enrich_batch(self, batch: Any) -> None:
        # columnar enrichment happens at display time via vocab; node name
        # tagging is carried in batch metadata by the agent layer
        pass


register(LocalManager())
