"""Runtimes: the lifecycle abstraction of a gadget run (ref:
pkg/runtime/runtime.go:83-92 — Init, RunGadget, GetCatalog;
CombinedGadgetResult :42-47 for per-node results/errors).

The port's copy of ``inspektor_gadget_tpu/runtime`` runs locally only:
the gRPC fan-out runtime waits for ROADMAP item 18b (the fan-out).
"""

from .local import LocalRuntime
from .runtime import CombinedGadgetResult, GadgetResult, Runtime, build_catalog

__all__ = ["CombinedGadgetResult", "GadgetResult", "LocalRuntime", "Runtime", "build_catalog"]
