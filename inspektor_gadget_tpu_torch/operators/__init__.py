"""Operators over a gadget's events (the port's copy of
``inspektor_gadget_tpu/operators``): the registry, the dependency sort and
the enrich chain (`operators.operators`), the localmanager (container
filtering and enrichment) and the tpusketch sketch plane, registered
here in the reference's order like any other operator."""

from . import localmanager as _localmanager  # noqa: F401 -- registers first, as in the reference
from .operators import (Operator, OperatorInstance, Operators, get, get_all,
                        get_operators_for_gadget, install_operators, register,
                        sort_operators)
from .operators import clear as registry_clear
from .tpusketch import (HeavyHitterRow, ParamError, SketchConfig, SketchContext, SketchSummary,
                        TpuSketch, TpuSketchInstance, checkpoint_all, checkpoint_dir,
                        live_instances, set_checkpoint_dir)

__all__ = ["HeavyHitterRow", "Operator", "OperatorInstance", "Operators", "ParamError",
           "SketchConfig", "SketchContext", "SketchSummary", "TpuSketch", "TpuSketchInstance",
           "checkpoint_all", "checkpoint_dir", "get", "get_all", "get_operators_for_gadget",
           "install_operators", "live_instances", "register",
           "registry_clear", "set_checkpoint_dir", "sort_operators"]
