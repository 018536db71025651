"""Host-side event sources and the pinned staging ring (the native
capture binding is `sources.bridge`)."""

from .batch import EventBatch, FoldedBatch
from .staging import H2DStager, PinnedBufferPool
from .synthetic import PySyntheticSource, ZipfFoldedSource

__all__ = ["EventBatch", "FoldedBatch", "H2DStager", "PinnedBufferPool", "PySyntheticSource",
           "ZipfFoldedSource"]
