"""Host utilities: checkpoint files of sketch and scorer state."""

from .checkpoint import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
