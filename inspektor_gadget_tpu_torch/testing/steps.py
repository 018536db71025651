"""Test steps: ordered commands with start/stop + guaranteed cleanup.

Semantics mirror integration/teststeps.go:64-113 — non-cleanup steps run
in order (start-and-stop steps are started and left running), started
steps are stopped in reverse order after an optional settle delay, and
cleanup steps ALWAYS run last, even when an earlier step failed.
Command matches integration/command.go: a subprocess with expected-string
/ expected-regexp / expected-fn verification, SIGINT-based stop for
streaming gadgets, and a `cleanup` flag.

The port's copy of ``inspektor_gadget_tpu/testing/steps.py``; `ig_cli`
names the port's CLI.
"""

from __future__ import annotations

import io
import re
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Protocol, Sequence


class StepError(AssertionError):
    pass


class TestStep(Protocol):
    def run(self) -> None: ...
    def start(self) -> None: ...
    def stop(self) -> None: ...
    @property
    def is_cleanup(self) -> bool: ...
    @property
    def is_start_and_stop(self) -> bool: ...
    @property
    def running(self) -> bool: ...


@dataclass
class Command:
    """A subprocess step (ref: integration/command.go Command struct)."""

    name: str
    cmd: Sequence[str]
    expected_string: str | None = None
    expected_regexp: str | None = None
    expected_output_fn: Callable[[str], None] | None = None
    cleanup: bool = False
    start_and_stop: bool = False
    timeout: float = 120.0
    # SIGINT grace before SIGKILL on stop (streaming gadgets exit cleanly
    # on interrupt, like execsnoop-style Ctrl^C in the reference)
    stop_grace: float = 10.0

    # stop() waits up to this long for the process to produce its first
    # output before sending SIGINT (slow torch-importing startups would
    # otherwise be interrupted before their signal handler exists)
    ready_timeout: float = 60.0

    stdout: str = field(default="", init=False)
    stderr: str = field(default="", init=False)
    returncode: int | None = field(default=None, init=False)
    _proc: subprocess.Popen | None = field(default=None, init=False)
    _started: bool = field(default=False, init=False)
    _out_buf: io.StringIO = field(default_factory=io.StringIO, init=False)
    _ready: threading.Event = field(default_factory=threading.Event, init=False)
    _reader: threading.Thread | None = field(default=None, init=False)

    @property
    def is_cleanup(self) -> bool:
        return self.cleanup

    @property
    def is_start_and_stop(self) -> bool:
        return self.start_and_stop

    @property
    def running(self) -> bool:
        return self._started

    def run(self) -> None:
        r = subprocess.run(list(self.cmd), capture_output=True, text=True,
                           timeout=self.timeout)
        self.stdout, self.stderr, self.returncode = r.stdout, r.stderr, r.returncode
        if not self.cleanup and r.returncode != 0:
            raise StepError(
                f"step {self.name!r} exited {r.returncode}:\n{r.stderr}")
        self._verify()

    def start(self) -> None:
        self._proc = subprocess.Popen(
            list(self.cmd), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self._started = True

        # drain stdout continuously: signals readiness and prevents the
        # pipe buffer from blocking long-running streams
        def drain():
            for line in self._proc.stdout:
                self._out_buf.write(line)
                self._ready.set()
            self._ready.set()

        self._reader = threading.Thread(target=drain, daemon=True)
        self._reader.start()

        def drain_err():
            self._err_text = self._proc.stderr.read()

        self._err_text = ""
        self._err_reader = threading.Thread(target=drain_err, daemon=True)
        self._err_reader.start()

    def output(self) -> str:
        """What a started command has written to stdout so far."""
        return self._out_buf.getvalue()

    def stop(self) -> None:
        if self._proc is None:
            raise StepError(f"step {self.name!r} was never started")
        self._ready.wait(self.ready_timeout)
        self._proc.send_signal(signal.SIGINT)
        try:
            self._proc.wait(timeout=self.stop_grace)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=5.0)
        self._err_reader.join(timeout=5.0)
        self.stdout = self._out_buf.getvalue()
        self.stderr = self._err_text
        self.returncode = self._proc.returncode
        self._started = False
        # SIGINT exit (-2 or 0 after handler) is the expected stop path
        if self.returncode not in (0, -signal.SIGINT, 130):
            raise StepError(
                f"step {self.name!r} exited {self.returncode} on stop:\n{self.stderr}")
        self._verify()

    def _verify(self) -> None:
        if self.expected_string is not None and self.stdout != self.expected_string:
            raise StepError(
                f"step {self.name!r}: output mismatch\n"
                f"expected: {self.expected_string!r}\ngot: {self.stdout!r}")
        if self.expected_regexp is not None and not re.search(
                self.expected_regexp, self.stdout, re.MULTILINE):
            raise StepError(
                f"step {self.name!r}: regexp {self.expected_regexp!r} "
                f"not found in output:\n{self.stdout}")
        if self.expected_output_fn is not None:
            self.expected_output_fn(self.stdout)

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._started = False


@dataclass
class FuncStep:
    """An in-process step (workload generation, assertions between steps)."""

    name: str
    fn: Callable[[], None]
    cleanup: bool = False

    _running: bool = field(default=False, init=False)

    @property
    def is_cleanup(self) -> bool:
        return self.cleanup

    @property
    def is_start_and_stop(self) -> bool:
        return False

    @property
    def running(self) -> bool:
        return self._running

    def run(self) -> None:
        self.fn()

    def start(self) -> None:  # pragma: no cover — FuncStep is never S&S
        self.run()

    def stop(self) -> None:  # pragma: no cover
        pass


def ig_cli(*args: str) -> list[str]:
    """Command line for the port's CLI, ``ig-tpu-torch`` (the
    built-binary analogue)."""
    return [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main", *args]


def run_test_steps(steps: Sequence[TestStep], *,
                   step_wait: float = 1.0,
                   before_cleanup: Callable[[], None] | None = None) -> None:
    """Run steps with the reference's ordering + cleanup guarantees
    (teststeps.go:64-113): start-and-stop steps are started inline, left
    running while later steps execute, then stopped in reverse order after
    `step_wait` seconds; cleanup steps run unconditionally at the end."""
    started: list[TestStep] = []
    first_error: BaseException | None = None
    try:
        for step in steps:
            if step.is_cleanup:
                continue
            if step.is_start_and_stop:
                step.start()
                started.append(step)
            else:
                step.run()
        if started:
            time.sleep(step_wait)
        for step in reversed(started):
            if step.running:
                step.stop()
                started.remove(step)
    except BaseException as e:  # noqa: BLE001 — re-raised after cleanup
        first_error = e
    finally:
        for step in reversed(started):
            if step.running and isinstance(step, Command):
                step.kill()
        if before_cleanup is not None:
            before_cleanup()
        for step in steps:
            if step.is_cleanup:
                try:
                    step.run()
                except Exception as e:  # noqa: BLE001
                    if first_error is None:
                        first_error = e
        if first_error is not None:
            raise first_error
