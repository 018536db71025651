"""SourceTraceGadget: shared machinery for capture-backed trace gadgets.

The role of the per-gadget Go tracers (pkg/gadgets/trace/*/tracer/tracer.go:
install BPF → perf-read loop → build typed events → callback, ~200-300 LoC
each) collapses here into one base class: pick a capture source (native or
synthetic), pop columnar batches, apply the mntns filter mask, feed the
batch path, and lazily decode rows for the display path. Concrete gadgets
supply the event dataclass + a row decoder + source kind.

The port's copy of ``inspektor_gadget_tpu/gadgets/source_gadget.py``,
with the per-container attach (`NsRefcountAttachMixin`,
`PtraceAttachMixin`: the localmanager operator attaches a source per
selected container and the run loop pops them all). ``--source
native|synthetic`` raises when the native capture library does not
build or load; ``--source auto`` keeps the reference's order and logs
the source it picked. The ``ig_source_events_filtered_total`` counter
also counts the events a native source's capture-side mntns filter
removed before its ring (`NativeCapture.filtered`), so popped plus
filtered plus dropped accounts for what the capture made.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np

from ..params import ParamDesc, ParamDescs, TypeHint
from ..sources import EventBatch, PySyntheticSource
from ..sources.bridge import NativeCapture, native_available
from ..sources.bridge import make_cfg as B_make_cfg
from ..telemetry import counter, gauge
from .context import GadgetContext

log = logging.getLogger("ig-tpu.source")

# capture-plane telemetry, batch-grain (one lock touch per pop, never per
# event — the pop loop is the display-path ceiling)
_tm_batches = counter("ig_source_batches_total",
                      "batches popped from capture sources", ("gadget",))
_tm_events = counter("ig_source_events_total",
                     "events popped from capture sources", ("gadget",))
_tm_filtered = counter("ig_source_events_filtered_total",
                       "events removed by kind/mntns filters", ("gadget",))
_tm_dropped = counter("ig_source_events_dropped_total",
                      "upstream capture-ring drops", ("gadget",))
_tm_queue = gauge("ig_source_queue_events",
                  "events in the last pop (pinned at batch-size under "
                  "backlog)", ("gadget",))
_tm_rows = counter("ig_display_rows_total",
                   "rows surviving display filters and decoded for output",
                   ("gadget",))


def source_params() -> ParamDescs:
    """Params shared by every capture-backed gadget."""
    return ParamDescs([
        ParamDesc(key="source", default="auto",
                  description="capture backend",
                  possible_values=("auto", "native", "synthetic", "pysynthetic")),
        ParamDesc(key="rate", default="100000", type_hint=TypeHint.FLOAT,
                  description="synthetic event rate/sec"),
        ParamDesc(key="vocab", default="1000", type_hint=TypeHint.INT),
        ParamDesc(key="zipf", default="1.2", type_hint=TypeHint.FLOAT),
        ParamDesc(key="seed", default="0", type_hint=TypeHint.INT),
        ParamDesc(key="batch-size", default="8192", type_hint=TypeHint.INT),
    ])


def container_key(container) -> str:
    """The one key attach and detach must agree on, or detached sources
    leak (prefer the runtime id; a bare pid for fake/test containers)."""
    return (getattr(container, "id", "")
            or str(getattr(container, "pid", 0)))


# kernel pseudo-filesystems: no value watching their churn, and fanotify
# marks there can fail
_FANOTIFY_SKIP_FSTYPES = {
    "proc", "sysfs", "devpts", "devtmpfs", "cgroup", "cgroup2",
    "securityfs", "debugfs", "tracefs", "mqueue", "bpf", "fusectl",
    "configfs", "pstore", "efivarfs",
}


def _unescape_mountinfo(path: str) -> str:
    """mountinfo octal-escapes spaces/tabs/backslashes (\\040 etc.) in
    path fields; decode them or mounts at such paths get nonexistent mark
    paths and silently drop out of coverage."""
    if "\\" not in path:
        return path
    out = []
    i = 0
    while i < len(path):
        c = path[i]
        if c == "\\" and i + 3 < len(path) + 1 and path[i + 1:i + 4].isdigit():
            try:
                out.append(chr(int(path[i + 1:i + 4], 8)))
                i += 4
                continue
            except ValueError:
                pass
        out.append(c)
        i += 1
    return "".join(out)


def fanotify_mount_paths(pid: int, max_marks: int = 32) -> list[str]:
    """Markable mounts of a container: its root mount plus submounts
    (volumes, emptyDirs) via /proc/<pid>/root/<target> — all reachable
    without entering the mount ns. Mounts created after the snapshot are
    the remaining gap vs the reference's kprobes. Returned as a LIST —
    join with the \\x1e list separator (make_cfg does this), never ':',
    which is legal inside mount points."""
    root = f"/proc/{pid}/root"
    paths = [root]
    try:
        with open(f"/proc/{pid}/mountinfo") as f:
            for line in f:
                dash = line.find(" - ")
                if dash < 0:
                    continue
                fields = line.split()
                target = _unescape_mountinfo(
                    fields[4] if len(fields) > 4 else "")
                fstype = line[dash + 3:].split()[0]
                if (not target or target == "/"
                        or fstype in _FANOTIFY_SKIP_FSTYPES):
                    continue
                paths.append(root + target)
                if len(paths) >= max_marks:
                    break
    except OSError:
        pass  # container gone mid-attach: root mark alone
    return paths


class NsRefcountAttachMixin:
    """Per-container attach with ONE source per distinct namespace (ref:
    networktracer/tracer.go:54-220's refcounted per-netns attachments).
    Pod containers sharing a namespace map onto one attachment; containers
    in the gadget's own namespace are no-ops (the main source covers them,
    and procfs-discovered host processes would otherwise re-attach the
    host view). Subclasses set attach_ns ("net"/"mnt") and implement
    _ns_source_args(pid) -> (kind, cfg, seed) — seed carries a netns fd
    for packet sources, 0 otherwise. All state is mutated under
    _attach_lock: discovery pumps publish add/remove from several threads,
    and the source pop happens under the SAME lock as the refcount delete
    so a concurrent attach can never have its fresh source retired by an
    in-flight detach."""

    attach_ns = "net"
    attach_requires_selector = False
    attach_replaces_main = False

    def _ns_source_args(self, pid: int) -> tuple[int, str, int]:
        raise NotImplementedError

    def _ns_attach_state(self):
        if not hasattr(self, "_ns_refs"):
            import os
            self._ns_refs = {}        # ns inode -> refcount
            self._container_ns = {}   # container key -> ns inode
            self._self_ns = os.stat(
                f"/proc/self/ns/{self.attach_ns}").st_ino
        return self._ns_refs, self._container_ns

    def attach_container(self, container) -> None:
        import os
        pid = int(getattr(container, "pid", 0))
        if pid <= 0:
            raise ValueError(f"attach needs a live pid, got {pid}")
        ino = os.stat(f"/proc/{pid}/ns/{self.attach_ns}").st_ino
        ckey = container_key(container)
        with self._attach_lock:
            refs, by_container = self._ns_attach_state()
            if ino == self._self_ns:
                return
            if ino in refs:
                refs[ino] += 1
                by_container[ckey] = ino
                return
        # slow path outside the lock (fd open + native create); the
        # mapping is recorded only AFTER the ref is taken, so a failed
        # attach can't leave a phantom entry whose detach would tear
        # down someone else's source
        kind, cfg, seed = self._ns_source_args(pid)
        try:
            self._attach_native_source(
                f"{self.attach_ns}ns-{ino}", kind, cfg=cfg, seed=seed)
        except Exception:
            if seed:
                import os as _os
                _os.close(seed)
            raise
        with self._attach_lock:
            refs, by_container = self._ns_attach_state()
            refs[ino] = refs.get(ino, 0) + 1
            by_container[ckey] = ino

    def detach_container(self, container) -> None:
        with self._attach_lock:
            refs, by_container = self._ns_attach_state()
            ino = by_container.pop(container_key(container), None)
            if ino is None or ino not in refs:
                return
            refs[ino] -= 1
            if refs[ino] > 0:
                return
            del refs[ino]
            src = self._attach_sources.pop(f"{self.attach_ns}ns-{ino}",
                                           None)
        if src is not None:
            self._retire(src)


class PtraceAttachMixin:
    """Attacher implementation for ptrace-window gadgets: a container
    filter auto-attaches the syscall stream to each matching container's
    init pid, so capabilities/fsslower/audit-seccomp/traceloop work
    per-container without an explicit --command/--pid (ref: the
    reference's per-container attach model, localmanager.go:230-260)."""

    # ptrace-attaching every discovered process would trace the whole
    # host; the localmanager only attaches when a container selector is set
    attach_requires_selector = True
    # the per-container ptrace stream supersedes any system-wide window
    # (avoids double-reporting, e.g. trace/signal netlink + ptrace)
    attach_replaces_main = True

    def attach_container(self, container) -> None:
        self._attach_ptrace_pid(int(getattr(container, "pid", 0)),
                                container_key(container))

    def detach_container(self, container) -> None:
        self._detach_key(container_key(container))


class SourceTraceGadget:
    """Concrete subclasses set: native_kind (proc capture), synth_kind
    (synthetic), decode_row(batch, i) -> event. kind_filter restricts the
    stream to the gadget's event kinds when the source multiplexes several
    (e.g. the ptrace stream carries syscalls + signals + capabilities)."""

    native_kind: int | None = None
    synth_kind: int = 1
    kind_filter: tuple[int, ...] | None = None
    # set by the localmanager when an Attacher gadget runs with a container
    # selector: containers may match later, so the gadget must wait for
    # attaches instead of failing "no target" at startup
    attach_pending: bool = False
    # Attacher gadgets whose attach sources REPLACE the main source (the
    # per-container ptrace stream supersedes the system-wide window, else
    # e.g. trace/signal would report each fatal signal twice: once from
    # netlink exits, once from the ptrace delivery stop)
    attach_replaces_main: bool = False

    # event-field → wire-column mapping for the vectorized display path;
    # subclasses extend when they expose more pass-through numeric fields
    display_wire_cols: dict[str, str] = {
        "pid": "pid", "ppid": "ppid", "uid": "uid",
        "mountnsid": "mntns", "timestamp": "ts",
    }

    def __init__(self, ctx: GadgetContext):
        self.ctx = ctx
        self._event_handler: Callable[[Any], None] | None = None
        self._batch_handler: Callable[[EventBatch], None] | None = None
        self._mntns_filter: set[int] | None = None
        # display filters pushed down by the CLI (ctx.extra) so the hot
        # loop only materializes surviving rows (ref: the tracer hot-loop
        # contract, trace/exec/tracer/tracer.go:134-188 — filter before
        # build, never after)
        self._display_filters = list(ctx.extra.get("display_filters") or [])
        self._display_columns = ctx.extra.get("display_columns")
        self._key_cache: dict[int, str] = {}
        if self._display_filters:
            ctx.extra["display_filters_applied"] = True
        self._is_native = False
        # per-container attached sources (task: Attacher path for ptrace
        # gadgets — ref localmanager.go:230-260 per-container attach)
        self._attach_sources: dict[str, NativeCapture] = {}
        # detached-but-not-yet-freed sources: detach only stop()s (the run
        # loop may still hold the handle mid-pop); close happens at run
        # teardown, never concurrently with a pop
        self._retired_sources: list[NativeCapture] = []
        import threading
        self._attach_lock = threading.Lock()
        self._current_source = None
        p = ctx.gadget_params
        self._mode = p.get("source").as_string() if "source" in p else "auto"
        self._rate = p.get("rate").as_float() if "rate" in p else 100000.0
        self._vocab = p.get("vocab").as_int() if "vocab" in p else 1000
        self._zipf = p.get("zipf").as_float() if "zipf" in p else 1.2
        self._seed = p.get("seed").as_int() if "seed" in p else 0
        self._batch_size = p.get("batch-size").as_int() if "batch-size" in p else 8192
        self.source = None
        g = ctx.desc.full_name
        self._m_batches = _tm_batches.labels(gadget=g)
        self._m_events = _tm_events.labels(gadget=g)
        self._m_filtered = _tm_filtered.labels(gadget=g)
        self._m_dropped = _tm_dropped.labels(gadget=g)
        self._m_queue = _tm_queue.labels(gadget=g)
        self._m_rows = _tm_rows.labels(gadget=g)

    # capability protocols --------------------------------------------------

    def set_event_handler(self, handler: Callable[[Any], None]) -> None:
        self._event_handler = handler

    def set_batch_handler(self, handler: Callable[[EventBatch], None]) -> None:
        self._batch_handler = handler

    def set_mntns_filter(self, mntns_ids: set[int] | None) -> None:
        self._mntns_filter = mntns_ids
        # live update: push into the C++ capture layer so filtering happens
        # before the ring, not on the Python display path (ref:
        # tracer-collection.go:100-134 mntnsset map updates)
        src = self.source
        if src is not None and isinstance(src, NativeCapture):
            src.set_filter(mntns_ids)

    # source selection ------------------------------------------------------

    def native_cfg(self) -> str:
        """Config string for cfg-kind native sources; subclasses override
        to pass command/pid/thresholds (see sources.bridge.make_cfg)."""
        return ""

    def native_ready(self) -> bool:
        """Whether the native source can run (e.g. ptrace-backed gadgets
        need a command/pid target). Auto mode falls back to synthetic when
        not ready; explicit native mode raises."""
        return self.native_kind is not None

    def has_explicit_target(self) -> bool:
        """True when the user named a target (--command/--pid) — an
        explicit target always gets its main source, even when a container
        selector also attaches per-container streams."""
        return bool(getattr(self, "_command", "") or
                    getattr(self, "_target_pid", 0))

    def window_supported(self, probe: Callable[[], bool]) -> bool:
        """Whether a kernel window `probe` answers for is there, asked
        once --source is known: an explicit synthetic run never builds
        the native library, --source auto asks only where it builds, and
        --source native lets the probe raise when it does not."""
        if self._mode in ("synthetic", "pysynthetic"):
            return False
        if self._mode == "auto" and not native_available():
            return False
        return probe()

    def _make_source(self):
        mode = self._mode
        attach_mode = bool(self._attach_sources) or self.attach_pending
        # Attach sources replace the main window only when the user did NOT
        # name an explicit target: `--command X --containername foo` must
        # still spawn and trace X (the selector adds streams, it never
        # silently drops the user's target).
        if mode in ("auto", "native") and attach_mode and (
                not self.native_ready()
                or (self.attach_replaces_main
                    and not self.has_explicit_target())):
            if not native_available():
                raise RuntimeError(
                    f"{type(self).__name__}: container auto-attach needs "
                    "the native capture library, which is unavailable")
            # per-container attached sources carry (or will carry, once a
            # container matches the selector) the capture; no main source
            if not self._attach_sources:
                self.ctx.logger.info(
                    "%s: no container matches the selector yet; waiting "
                    "for attach", type(self).__name__)
            self._threaded = True
            self._is_native = True
            return None
        if mode == "auto":
            if self.native_ready() and native_available():
                mode = "native"
            elif self.native_kind is not None and native_available():
                # a real window that cannot run without a target: fail
                # rather than emit fabricated rows labeled as real
                raise RuntimeError(
                    f"{type(self).__name__}: the native capture window "
                    "needs a target — pass --command/--pid, or set a "
                    "container filter to auto-attach; use "
                    "--source synthetic explicitly for a demo stream")
            elif native_available():
                mode = "synthetic"
            else:
                mode = "pysynthetic"
            log.info("%s: --source auto picked %s", type(self).__name__, mode)
        if mode == "native":
            if self.native_kind is None:
                raise RuntimeError(
                    f"{type(self).__name__}: native capture unavailable")
            if not self.native_ready():
                raise RuntimeError(
                    f"{type(self).__name__}: native source needs a target "
                    "(--command/--pid or a container filter to auto-attach)")
            # a library that does not build or load raises here
            src = NativeCapture(self.native_kind, ring_pow2=20,
                                batch_size=self._batch_size,
                                cfg=self.native_cfg())
            if self._mntns_filter is not None:
                src.set_filter(self._mntns_filter)
            src.start()
            self._threaded = True
            self._is_native = True
            return src
        if mode == "synthetic":
            src = NativeCapture(self.synth_kind, seed=self._seed,
                                rate=self._rate, vocab=self._vocab,
                                zipf_s=self._zipf, ring_pow2=20,
                                batch_size=self._batch_size)
            if self._mntns_filter is not None:
                src.set_filter(self._mntns_filter)
            src.start()
            self._threaded = True
            return src
        self._threaded = False
        return PySyntheticSource(kind=self.synth_kind, seed=self._seed,
                                 vocab=self._vocab, zipf_s=self._zipf,
                                 batch_size=self._batch_size)

    # per-container attach (ref: localmanager.go:230-260 Attacher path) -----

    def _attach_native_source(self, key: str, kind: int, cfg: str = "",
                              ring_pow2: int = 18, seed: int = 0) -> None:
        """Attach any native capture keyed to a container; the run loop
        pops it alongside the main source (ref: localmanager.go:230-260
        per-container attach). seed carries the netns fd for packet
        sources (numeric-create kinds)."""
        src = NativeCapture(kind, ring_pow2=ring_pow2, seed=seed,
                            batch_size=self._batch_size, cfg=cfg)
        src.start()
        with self._attach_lock:
            old = self._attach_sources.get(key)
            self._attach_sources[key] = src
        if old is not None:  # re-attach for the same key: retire the old one
            self._retire(old)

    def _attach_ptrace_pid(self, pid: int, key: str) -> None:
        """Attach a ptrace capture to an existing pid (a container's init
        process)."""
        from ..sources.bridge import SRC_PTRACE
        if pid <= 0:
            raise ValueError(f"attach needs a live pid, got {pid}")
        self._attach_native_source(key, SRC_PTRACE, B_make_cfg(pid=pid))

    def _retire(self, src) -> None:
        """Stop a source but defer freeing: the run loop may hold its handle
        mid-pop (freeing here would be a native use-after-free); the handle
        stays valid until run teardown / GC closes it."""
        try:
            src.stop()
        except Exception as e:  # noqa: BLE001 — retire must not fail the run
            log.debug("source stop on retire failed: %r", e)
        with self._attach_lock:
            self._retired_sources.append(src)

    def _detach_key(self, key: str) -> None:
        with self._attach_lock:
            src = self._attach_sources.pop(key, None)
        if src is not None:
            self._retire(src)

    def _active_sources(self) -> list:
        with self._attach_lock:
            extras = list(self._attach_sources.values())
        return ([self.source] if self.source is not None else []) + extras

    # run loop --------------------------------------------------------------

    def run(self, ctx: GadgetContext) -> None:
        self.source = self._make_source()
        deadline_hit = False
        try:
            while not ctx.done and not deadline_hit:
                got = 0
                for src in self._active_sources():
                    self._current_source = src
                    batch = src.pop()
                    if batch.count == 0:
                        continue
                    got += batch.count
                    popped = batch.count
                    self._m_batches.inc()
                    self._m_events.inc(popped)
                    self._m_queue.set(popped)
                    # baseline lives ON the source (a dict keyed by id(src)
                    # would survive the source and alias a recycled id)
                    prev_drops = getattr(src, "_tm_drops_seen", 0)
                    if batch.drops > prev_drops:
                        self._m_dropped.inc(batch.drops - prev_drops)
                        src._tm_drops_seen = batch.drops
                    self._count_capture_filtered(src)
                    self._apply_kind_filter(batch)
                    self._apply_filter(batch)
                    if batch.count != popped:
                        self._m_filtered.inc(popped - batch.count)
                    if batch.count:
                        self.process_batch(batch)
                    if batch.count and self._batch_handler is not None:
                        self._batch_handler(batch)
                    if batch.count and self._event_handler is not None:
                        self._emit_display_rows(batch)
                if got == 0:
                    if self._source_done():
                        break  # e.g. traced command exited, ring drained
                    if ctx.sleep_or_done(0.01):
                        break
                    continue
                if not self._threaded:
                    # pysynthetic generates instantly; pace by rate
                    if ctx.sleep_or_done(got / max(self._rate, 1.0)):
                        break
        finally:
            with self._attach_lock:
                retired = self._retired_sources
                self._retired_sources = []
            for src in self._active_sources() + retired:
                try:
                    src.stop()
                    self._count_capture_filtered(src)
                    src.close()
                except Exception as e:  # noqa: BLE001 — teardown best-effort
                    log.debug("source teardown failed: %r", e)

    def _count_capture_filtered(self, src) -> None:
        """Add what a native source's capture-side mntns filter removed
        since the last look (the filter runs before the ring, so the pop
        never sees those events)."""
        if not isinstance(src, NativeCapture):
            return
        seen = getattr(src, "_tm_filtered_seen", 0)
        now = src.filtered()
        if now > seen:
            self._m_filtered.inc(now - seen)
            src._tm_filtered_seen = now

    def _source_done(self) -> bool:
        """True when no source will ever produce again (a ptrace-spawned
        command has exited and its ring is drained). Attach-mode gadgets
        keep running: new containers may appear at any time."""
        from ..sources.bridge import SRC_PTRACE
        with self._attach_lock:
            if self._attach_sources:
                return False
        src = self.source
        if (self._is_native and isinstance(src, NativeCapture)
                and src.kind == SRC_PTRACE):
            return src.ptrace_exit_status() >= 0
        return False

    @staticmethod
    def _compact(batch: EventBatch, keep: np.ndarray) -> None:
        for _name, arr in batch.cols.items():
            arr[: len(keep)] = arr[keep]
        if batch.comm is not None:
            batch.comm[: len(keep)] = batch.comm[keep]
        batch.count = len(keep)

    def _apply_kind_filter(self, batch: EventBatch) -> None:
        # Only native sources multiplex kinds; synthetic streams carry one
        # fabricated kind that stands in for the gadget's own.
        if self.kind_filter is None or batch.count == 0 or not self._is_native:
            return
        kinds = batch.cols["kind"][: batch.count]
        keep = np.flatnonzero(np.isin(
            kinds, np.asarray(self.kind_filter, dtype=kinds.dtype)))
        if len(keep) != batch.count:
            self._compact(batch, keep)

    def _apply_filter(self, batch: EventBatch) -> None:
        """Python-side mntns compaction — only needed for the pysynthetic
        source; native sources filter in the capture thread (set_filter)."""
        if self._mntns_filter is None or batch.count == 0:
            return
        if self._threaded:
            return  # already filtered at capture
        mntns = batch.cols["mntns"][: batch.count]
        allowed = np.isin(mntns, np.fromiter(self._mntns_filter, dtype=np.uint64)
                          if self._mntns_filter else np.array([], dtype=np.uint64))
        self._compact(batch, np.flatnonzero(allowed))

    def process_batch(self, batch: EventBatch) -> None:
        """Internal hook run on every batch regardless of external handlers
        (gadgets that accumulate state — advise/traceloop — override this)."""

    # display ---------------------------------------------------------------

    def decode_row(self, batch: EventBatch, i: int) -> Any:
        raise NotImplementedError

    def decode_rows(self, batch: EventBatch, idx) -> list:
        """Decode a set of row indices; subclasses may vectorize."""
        return [self.decode_row(batch, int(i)) for i in idx]

    def _display_batch_mask(
            self, batch: EventBatch) -> tuple[np.ndarray | None, list]:
        """Split the pushed-down filters into (columnar prefilter mask,
        residual row filters). The mask is a NECESSARY condition — exact
        for numeric wire columns, a prefix test for comm (the wire carries
        an 8-byte prefix; rows with no comm bytes pass through to the
        residual exact check, since their display comm resolves from the
        vocab instead)."""
        n = batch.count
        mask: np.ndarray | None = None
        residual: list = []
        for f in self._display_filters:
            wire = self.display_wire_cols.get(f.column)
            m = None
            if wire is not None and wire in batch.cols and f.op != "re":
                from ..columns.filter import numeric_col_mask
                m = numeric_col_mask(batch.cols[wire][:n], f)
                if m is None:  # unrepresentable/non-canonical: row path
                    residual.append(f)
                    continue
            elif (f.column == "comm" and f.op == "eq" and not f.negate
                  and batch.comm is not None):
                raw = f.value.encode()
                # the 8-byte comm prefix is one u64 word: an exact match
                # (name shorter than the field, NUL-padded) is a single
                # vector compare
                comm_words = batch.comm[:n].reshape(n, 8).view(np.uint64)[:, 0]
                if len(raw) < 8:
                    want = np.frombuffer(raw.ljust(8, b"\0"),
                                         dtype=np.uint64)[0]
                    m = comm_words == want
                    exact = True
                else:  # prefix-only test; residual confirms the full name
                    want = np.frombuffer(raw[:8], dtype=np.uint64)[0]
                    m = comm_words == want
                    exact = False
                # comm-less rows resolve their name from the vocab at
                # decode time — they need the residual exact check; when
                # none exist and the word compare is exact, the mask alone
                # decides and survivors skip re-matching
                no_comm = comm_words == 0
                if not exact or no_comm.any():
                    m = m | no_comm
                    residual.append(f)
            if m is None:
                residual.append(f)
            else:
                mask = m if mask is None else mask & m
        return mask, residual

    def _emit_display_rows(self, batch: EventBatch) -> None:
        # decode_row may return None for rows a gadget declines to surface
        # (e.g. audit/seccomp's non-denial syscalls) — those must be
        # skipped BEFORE filtering, not handed to match_event
        handler = self._event_handler
        shown = 0
        if not self._display_filters:
            for ev in self.decode_rows(batch, range(batch.count)):
                if ev is not None:
                    handler(ev)
                    shown += 1
            if shown:
                self._m_rows.inc(shown)
            return
        mask, residual = self._display_batch_mask(batch)
        idx = np.flatnonzero(mask) if mask is not None else range(batch.count)
        if residual:
            from ..columns import match_event
            cols = self._display_columns or self.ctx.columns
            for ev in self.decode_rows(batch, idx):
                if ev is not None and match_event(ev, residual, cols):
                    handler(ev)
                    shown += 1
        else:
            for ev in self.decode_rows(batch, idx):
                if ev is not None:
                    handler(ev)
                    shown += 1
        if shown:
            self._m_rows.inc(shown)

    def resolve_keys_bulk(self, keys: np.ndarray) -> list[str]:
        """Resolve many key hashes with one native crossing PER SOURCE —
        never a per-key ctypes call (an unknown high-cardinality key would
        otherwise cost ~15us each in fallback lookups). Keys no source
        knows resolve to ""."""
        keys64 = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys64.size
        vals: list[str] = [""] * n
        if n == 0:
            return vals
        cur = self._current_source
        sources = ([cur] if cur is not None else []) + [
            s for s in self._active_sources() if s is not cur]
        pending = np.arange(n)
        for src in sources:
            if pending.size == 0:
                break
            if hasattr(src, "vocab_lookup_batch"):
                got = src.vocab_lookup_batch(keys64[pending])
            else:
                got = [src.vocab_lookup(int(k)) for k in keys64[pending]]
            still = []
            for idx, v in zip(pending.tolist(), got):
                if v:
                    vals[idx] = v
                else:
                    still.append(idx)
            pending = np.asarray(still, dtype=np.int64)
        return vals

    def resolve_key_cached(self, key_hash: int) -> str:
        """Memoized resolve_key for display decode loops: the vocab is a
        ctypes round-trip per call, but key hashes repeat constantly
        (comms, argvs). Bounded: cleared when it hits 64k entries (real
        captures can mint unbounded distinct args strings)."""
        cache = self._key_cache
        v = cache.get(key_hash)
        if v is None:
            v = self.resolve_key(key_hash)
            if len(cache) >= 65536:
                cache.clear()
            cache[key_hash] = v
        return v

    def resolve_key(self, key_hash: int) -> str:
        # prefer the source that produced the batch being decoded; fall
        # back to the others (each capture keeps its own vocab side-table)
        cur = self._current_source
        if cur is not None:
            s = cur.vocab_lookup(key_hash)
            if s:
                return s
        for src in self._active_sources():
            if src is cur:
                continue
            s = src.vocab_lookup(key_hash)
            if s:
                return s
        return ""
