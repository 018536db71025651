"""KubeManager operator: agent-fed container filtering/enrichment.

Reference contract: pkg/operators/kubemanager — identical role to
LocalManager but backed by the node daemon's container collection, which is
fed by runtime hooks and the pod informer instead of local discovery
(kubemanager.go:54 SetGadgetTracerMgr, CanOperateOn :126). Here the agent's
hook RPCs (AddContainer/RemoveContainer, agent/service.py) feed the SAME
ContainerCollection that LocalManager owns, so KubeManager delegates to it
while contributing the k8s-facing selector params (namespace/podname/
containername/selector labels).

The port's copy of ``inspektor_gadget_tpu/operators/kubemanager.py``.
"""

from __future__ import annotations

from typing import Any

from ..containers import ContainerSelector
from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..params import ParamDesc, ParamDescs, Params
from .localmanager import LocalManager, LocalManagerInstance
from .operators import Operator, register


class KubeManager(Operator):
    name = "kubemanager"

    def dependencies(self) -> list[str]:
        return ["localmanager"]  # shares its collections

    def instance_params(self) -> ParamDescs:
        # ref: kubemanager instance params (namespace/podname/containername/
        # selector)
        return ParamDescs([
            ParamDesc(key="namespace", default=""),
            ParamDesc(key="podname", default=""),
            ParamDesc(key="containername", default=""),
            ParamDesc(key="selector", default="",
                      description="label selector key=value[,key=value]"),
        ])

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        return True

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "KubeManagerInstance":
        return KubeManagerInstance(self, ctx, gadget, instance_params)


class KubeManagerInstance(LocalManagerInstance):
    def __init__(self, op: KubeManager, ctx: GadgetContext, gadget: Any,
                 params: Params):
        from .operators import get as get_op
        lm: LocalManager = get_op("localmanager")
        super().__init__(lm, ctx, gadget, lm.instance_params().to_params())
        self.name = op.name
        labels = {}
        sel = params.get("selector").as_string() if "selector" in params else ""
        for pair in filter(None, sel.split(",")):
            k, _, v = pair.partition("=")
            labels[k] = v
        self.selector = ContainerSelector(
            namespace=params.get("namespace").as_string() if "namespace" in params else "",
            pod=params.get("podname").as_string() if "podname" in params else "",
            name=params.get("containername").as_string() if "containername" in params else "",
            labels=labels,
        )
        self._tracer_id = f"kube-{ctx.run_id}"
        # the base __init__ marked from the (empty) localmanager params;
        # re-mark with the real k8s selector
        self._mark_selector_active()


register(KubeManager())
