"""Runtimes: the lifecycle abstraction shared by local and remote execution
(ref: pkg/runtime/runtime.go:83-92 — Init, RunGadget, GetCatalog;
CombinedGadgetResult :42-47 for per-node results/errors).

The port's copy of ``inspektor_gadget_tpu/runtime``: `LocalRuntime` and
the gRPC fan-out, `GrpcRuntime`, which loads on first use.
"""

from .local import LocalRuntime
from .runtime import CombinedGadgetResult, GadgetResult, Runtime, build_catalog

__all__ = ["CombinedGadgetResult", "GadgetResult", "GrpcRuntime", "LocalRuntime", "Runtime",
           "build_catalog"]


def __getattr__(name):
    # lazy: GrpcRuntime pulls in grpc only when used
    if name == "GrpcRuntime":
        from .grpc_runtime import GrpcRuntime
        return GrpcRuntime
    raise AttributeError(name)
