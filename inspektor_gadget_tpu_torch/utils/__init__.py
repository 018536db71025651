"""Host utilities: checkpoint files of sketch and scorer state, and the
leveled logger facade (`utils.logger`)."""

from .checkpoint import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
