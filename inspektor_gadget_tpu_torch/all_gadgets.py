"""Import every gadget and operator so they register, in the
reference's order (the port's copy of
``inspektor_gadget_tpu/all_gadgets.py``): the trace gadgets, the top
gadgets, the snapshot pair, the profile, audit, advise and traceloop
gadgets, the localmanager, tpusketch, kubemanager, kubeipresolver,
alerts and capture operators, then top/recordings and top/windows."""

from .gadgets.trace import exec as _exec  # noqa: F401
from .gadgets.trace import tcp as _tcp  # noqa: F401
from .gadgets.trace import simple as _simple  # noqa: F401
from .gadgets.trace import network_family as _network_family  # noqa: F401
from .gadgets.top import file as _top_file  # noqa: F401
from .gadgets.top import tcp as _top_tcp  # noqa: F401
from .gadgets.top import block_io as _top_block_io  # noqa: F401
from .gadgets.top import sketch as _top_sketch  # noqa: F401
from .gadgets.top import self as _top_self  # noqa: F401
from .gadgets.top import metrics as _top_metrics  # noqa: F401
from .gadgets.top import alerts as _top_alerts  # noqa: F401
from .gadgets.snapshot import process as _snap_process  # noqa: F401
from .gadgets.snapshot import socket as _snap_socket  # noqa: F401
from .gadgets.profile import cpu as _profile_cpu  # noqa: F401
from .gadgets.profile import block_io as _profile_block_io  # noqa: F401
from .gadgets.audit import seccomp as _audit_seccomp  # noqa: F401
from .gadgets.advise import seccomp_profile as _advise_seccomp  # noqa: F401
from .gadgets.advise import network_policy as _advise_netpol  # noqa: F401
from .gadgets.traceloop import traceloop as _traceloop  # noqa: F401
from .operators import localmanager as _localmanager  # noqa: F401
from .operators import tpusketch as _tpusketch  # noqa: F401
from .operators import kubemanager as _kubemanager  # noqa: F401
from .operators import kubeipresolver as _kubeipresolver  # noqa: F401
from .operators import alertsop as _alertsop  # noqa: F401
from .capture import operator as _captureop  # noqa: F401
from .gadgets.top import recordings as _top_recordings  # noqa: F401
from .gadgets.top import windows as _top_windows  # noqa: F401
