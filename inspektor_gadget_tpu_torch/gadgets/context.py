"""GadgetContext — the per-run bundle (ref: pkg/gadget-context/
gadget-context.go:35-80: ctx, id, params, runtime, logger, result,
timeout; WaitForTimeoutOrDone :137).

The port's copy of ``inspektor_gadget_tpu/gadgets/context.py`` with one
addition: ``device`` (default ``"cuda"``), the device the run's operators
put their state on. It is a name here; an operator resolves it
(`device.resolve_device`) where it first uses it, so a run that puts
nothing on a device (``list``, a ``trace exec`` without the sketch plane)
runs on any host.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any

from ..params import Collection, Params
from .interface import GadgetDesc


class GadgetContext:
    def __init__(
        self,
        desc: GadgetDesc,
        *,
        gadget_params: Params | None = None,
        operator_params: Collection | None = None,
        runtime_params: Params | None = None,
        timeout: float = 0.0,
        logger: logging.Logger | None = None,
        run_id: str | None = None,
        extra: dict[str, Any] | None = None,
        device: str = "cuda",
    ):
        self.desc = desc
        self.gadget_params = gadget_params if gadget_params is not None else desc.params().to_params()
        self.operator_params = operator_params if operator_params is not None else Collection()
        self.runtime_params = runtime_params if runtime_params is not None else Params()
        self.timeout = timeout
        self.logger = logger or logging.getLogger(f"ig-tpu.{desc.full_name}")
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.extra = extra or {}
        self.device = device
        self.columns = desc.columns()
        self._stop = threading.Event()
        self.result: Any = None
        self.error: Exception | None = None

    # lifecycle ----------------------------------------------------------

    def cancel(self) -> None:
        self._stop.set()

    @property
    def done(self) -> bool:
        return self._stop.is_set()

    def wait_for_timeout_or_done(self) -> None:
        """ref: gadget-context.go:137 WaitForTimeoutOrDone."""
        if self.timeout > 0:
            self._stop.wait(self.timeout)
            self._stop.set()
        else:
            self._stop.wait()

    def sleep_or_done(self, seconds: float) -> bool:
        """Sleep up to `seconds`; True if the context finished meanwhile."""
        return self._stop.wait(seconds)

    def deadline(self) -> float | None:
        return time.monotonic() + self.timeout if self.timeout > 0 else None
