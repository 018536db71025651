"""Import every ported gadget and operator so they register: trace/exec,
top/sketch, top/windows, top/alerts, top/recordings, and the
localmanager, tpusketch, kubemanager, kubeipresolver, alerts and capture
operators in the reference's order (the port's copy of
``inspektor_gadget_tpu/all_gadgets.py``, cut to what is ported)."""

from .gadgets.top import alerts as _top_alerts  # noqa: F401
from .gadgets.top import recordings as _top_recordings  # noqa: F401
from .gadgets.top import sketch as _top_sketch  # noqa: F401
from .gadgets.top import windows as _top_windows  # noqa: F401
from .gadgets.trace import exec as _exec  # noqa: F401
from .operators import localmanager as _localmanager  # noqa: F401
from .operators import tpusketch as _tpusketch  # noqa: F401
from .operators import kubemanager as _kubemanager  # noqa: F401
from .operators import kubeipresolver as _kubeipresolver  # noqa: F401
from .operators import alertsop as _alertsop  # noqa: F401
from .capture import operator as _captureop  # noqa: F401
