"""Import every ported gadget and operator so they register: trace/exec,
top/sketch, top/windows, top/alerts, top/recordings and the tpusketch,
alerts and capture operators (the port's copy of
``inspektor_gadget_tpu/all_gadgets.py``, cut to what is ported)."""

from .gadgets.top import alerts as _top_alerts  # noqa: F401
from .gadgets.top import recordings as _top_recordings  # noqa: F401
from .gadgets.top import sketch as _top_sketch  # noqa: F401
from .gadgets.top import windows as _top_windows  # noqa: F401
from .gadgets.trace import exec as _exec  # noqa: F401
from .operators import alertsop as _alertsop  # noqa: F401
from .operators import tpusketch as _tpusketch  # noqa: F401
from .capture import operator as _captureop  # noqa: F401
