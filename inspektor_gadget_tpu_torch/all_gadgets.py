"""Import every ported gadget and operator so they register: trace/exec,
top/sketch, top/windows and the tpusketch operator (the port's copy of
``inspektor_gadget_tpu/all_gadgets.py``, cut to what is ported)."""

from .gadgets.top import sketch as _top_sketch  # noqa: F401
from .gadgets.top import windows as _top_windows  # noqa: F401
from .gadgets.trace import exec as _exec  # noqa: F401
from .operators import tpusketch as _tpusketch  # noqa: F401
