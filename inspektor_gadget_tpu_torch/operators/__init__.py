"""Operators over a gadget's event batches: the tpusketch sketch plane."""

from .tpusketch import (HeavyHitterRow, ParamError, SketchConfig, SketchContext, SketchSummary,
                        TpuSketchInstance, checkpoint_all, checkpoint_dir, live_instances,
                        set_checkpoint_dir)

__all__ = ["HeavyHitterRow", "ParamError", "SketchConfig", "SketchContext", "SketchSummary",
           "TpuSketchInstance", "checkpoint_all", "checkpoint_dir", "live_instances",
           "set_checkpoint_dir"]
