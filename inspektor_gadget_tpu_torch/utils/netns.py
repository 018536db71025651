"""Network-namespace helpers (ref: pkg/netnsenter, pkg/rawsock).

netns_enter runs a callable inside another process's network namespace —
the reference locks an OS thread and setns's it (netnsenter); Python 3.12's
os.setns plus a dedicated thread gives the same isolation. netns_fd_for_pid
hands the capture layer the fd that PacketSniffSource setns's before
opening its AF_PACKET socket (rawsock.go:40-76's OpenRawSock contract).

The port's copy of ``inspektor_gadget_tpu/utils/netns.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable


def netns_fd_for_pid(pid: int) -> int:
    """Open /proc/<pid>/ns/net; caller owns the fd (the capture layer closes
    it on source destroy)."""
    return os.open(f"/proc/{pid}/ns/net", os.O_RDONLY)


def netns_enter(pid: int, fn: Callable[[], Any]) -> Any:
    """Run fn() on a thread joined to pid's netns; returns fn's result."""
    result: list[Any] = [None]
    error: list[BaseException | None] = [None]

    def body():
        fd = netns_fd_for_pid(pid)
        try:
            os.setns(fd, os.CLONE_NEWNET)
            result[0] = fn()
        except BaseException as e:  # propagate to caller
            error[0] = e
        finally:
            os.close(fd)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    if error[0] is not None:
        raise error[0]
    return result[0]
