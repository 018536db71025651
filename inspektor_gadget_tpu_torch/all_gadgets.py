"""Import every ported gadget and operator so they register, in the
reference's order (the port's copy of
``inspektor_gadget_tpu/all_gadgets.py``, cut to what is ported): the
twelve trace gadgets beside trace/exec, top/sketch, top/alerts, the
snapshot pair, the localmanager, tpusketch, kubemanager, kubeipresolver,
alerts and capture operators, then top/recordings and top/windows. The
gadgets still to port (top block-io, file, metrics, self and tcp;
profile; audit; advise; traceloop) are ROADMAP item 17b."""

from .gadgets.trace import exec as _exec  # noqa: F401
from .gadgets.trace import tcp as _tcp  # noqa: F401
from .gadgets.trace import simple as _simple  # noqa: F401
from .gadgets.trace import network_family as _network_family  # noqa: F401
from .gadgets.top import sketch as _top_sketch  # noqa: F401
from .gadgets.top import alerts as _top_alerts  # noqa: F401
from .gadgets.snapshot import process as _snap_process  # noqa: F401
from .gadgets.snapshot import socket as _snap_socket  # noqa: F401
from .operators import localmanager as _localmanager  # noqa: F401
from .operators import tpusketch as _tpusketch  # noqa: F401
from .operators import kubemanager as _kubemanager  # noqa: F401
from .operators import kubeipresolver as _kubeipresolver  # noqa: F401
from .operators import alertsop as _alertsop  # noqa: F401
from .capture import operator as _captureop  # noqa: F401
from .gadgets.top import recordings as _top_recordings  # noqa: F401
from .gadgets.top import windows as _top_windows  # noqa: F401
