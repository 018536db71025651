"""Host-side event sources and the pinned staging ring."""

from .staging import H2DStager, PinnedBufferPool
from .synthetic import ZipfFoldedSource

__all__ = ["H2DStager", "PinnedBufferPool", "ZipfFoldedSource"]
