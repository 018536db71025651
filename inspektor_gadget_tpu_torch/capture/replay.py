"""Deterministic replay: re-drive a recorded journal through the REAL
operator chain (enrich → tpusketch → alerts) on an injectable clock.

The journal's EV_BATCH_NPZ records are the input stream; its EV_SUMMARY
records are the harvest boundaries (replay disables the sketch plane's
wall-clock auto-harvest and harvests exactly where the original run
did, so the device math folds the same batches into the same epochs);
its EV_ALERT records are the recorded ground truth replayed transitions
are compared against. The alert engine runs on a ReplayClock driven by
recorded timestamps — debounce (`for`), cooldown, and hysteresis
decisions reproduce exactly, at recorded pace (`speed=1`), accelerated
(`speed=10`), or as fast as the machine goes (`speed=0`).

Determinism contract (asserted in tests and by `ig-tpu replay
--verify`): same journal → byte-identical summary digest sequence, and
the identical (rule, key, transition, epoch) alert sequence.

The port's copy of ``inspektor_gadget_tpu/capture/replay.py``:
`replay_journal` takes ``device=`` (default ``"cuda"``, no fallback)
and refolds the recorded batches on it, so a journal recorded by either
package replays on the card or on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

from ..agent import wire
from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc, GadgetType
from ..params import Collection, ParamDescs
from ..utils.logger import get_logger
from .journal import JournalReader, summary_digest, summary_to_dict

log = get_logger("ig-tpu.replay")


class ReplayClock:
    """Recorded-timeline clock: now() is seconds since the journal's
    first record, advanced only by the records themselves. Injected into
    the alert engine so time-based decisions replay identically no
    matter how fast the wall clock runs."""

    def __init__(self):
        self._epoch: float | None = None
        self._now = 0.0

    def advance_to(self, ts: float) -> None:
        if self._epoch is None:
            self._epoch = ts
        self._now = max(self._now, ts - self._epoch)

    def now(self) -> float:
        return self._now


class ReplaySource:
    """Source-interface adapter over a journal's recorded batches — what
    `bench run --replay` feeds the perf harness so stage numbers are
    reproducible input-for-input. Batches are decoded once up front;
    generate()/pop() hands them out in recorded order (cycling when
    `cycle`, the harness mode: a fixed input sequence per pass)."""

    def __init__(self, journal: "str | JournalReader", *, cycle: bool = False):
        reader = (journal if isinstance(journal, JournalReader)
                  else JournalReader(journal))
        self.reader = reader
        self.batches = [wire.decode_batch(payload)
                        for header, payload in reader.records(
                            types=(wire.EV_BATCH_NPZ,))]
        self.digest = reader.digest()
        self.cycle = cycle
        self._i = 0
        self._seq = 0

    def __len__(self) -> int:
        return len(self.batches)

    def start(self) -> None:  # interface parity
        pass

    def stop(self) -> None:
        pass

    def close(self) -> None:
        pass

    def generate(self, n: int | None = None):
        if not self.batches:
            raise ValueError(f"{self.reader.path}: journal carries no "
                             "EV_BATCH_NPZ records to replay")
        if self._i >= len(self.batches):
            if not self.cycle:
                from ..sources.batch import EventBatch
                return EventBatch.alloc(0, with_comm=False)
            self._i = 0
        b = self.batches[self._i]
        self._i += 1
        b.seq = self._seq
        self._seq += b.count
        return b

    pop = generate

    def reset(self) -> None:
        """Rewind to the first recorded batch (the harness warms up on
        recorded data, then measures the sequence from the start)."""
        self._i = 0
        self._seq = 0

    def exhausted(self) -> bool:
        return not self.cycle and self._i >= len(self.batches)

    def drops(self) -> int:
        return 0

    def vocab_lookup(self, key_hash: int) -> str:
        return ""


@dataclasses.dataclass
class ReplayResult:
    journal: str
    records: int
    batches: int
    events: int
    summaries: list[dict]
    digests: list[str]              # replayed harvest digests, in order
    recorded_digests: list[str]     # digests the original run journaled
    alerts: list[dict]              # replayed transitions (wire dict shape)
    recorded_alerts: list[dict]     # transitions the original run journaled
    losses: list[dict]
    manifest: dict

    @property
    def digests_match(self) -> bool:
        # the recorded run may have journaled digests replay can't have
        # produced (records past a torn tail never replay) — compare the
        # common prefix only when loss was accounted, exactly otherwise
        if self.losses:
            n = len(self.digests)
            return self.recorded_digests[:n] == self.digests
        return self.recorded_digests == self.digests

    @staticmethod
    def _transition_key(a: dict) -> tuple:
        return (a.get("rule", ""), a.get("key", ""),
                a.get("transition", ""), a.get("epoch", 0))

    @property
    def alerts_match(self) -> bool:
        got = [self._transition_key(a) for a in self.alerts]
        want = [self._transition_key(a) for a in self.recorded_alerts]
        if self.losses:
            return want[:len(got)] == got or got[:len(want)] == want
        return got == want


class _ReplayGadget:
    """Internal batch gadget that walks the journal: batches feed the
    operator chain, summary records trigger the live sketch instance's
    harvest at exactly the recorded boundaries."""

    def __init__(self, ctx: GadgetContext, reader: JournalReader,
                 clock: ReplayClock, speed: float,
                 collect: "ReplayResult"):
        self.ctx = ctx
        self.reader = reader
        self.clock = clock
        self.speed = speed
        self.collect = collect
        self._batch_handler: Callable[[Any], None] | None = None

    def set_batch_handler(self, handler: Callable[[Any], None]) -> None:
        self._batch_handler = handler

    def _sketch_instance(self):
        from ..operators import tpusketch
        for inst in tpusketch.live_instances():
            if inst.ctx.run_id == self.ctx.run_id:
                return inst
        return None

    def run(self, ctx: GadgetContext) -> None:
        prev_ts: float | None = None
        for header, payload in self.reader.records():
            if ctx.done:
                break
            self.collect.records += 1
            ts = float(header.get("ts", 0.0))
            if self.speed > 0 and prev_ts is not None and ts > prev_ts:
                if ctx.sleep_or_done((ts - prev_ts) / self.speed):
                    break
            prev_ts = ts
            self.clock.advance_to(ts)
            t = header.get("type")
            if t == wire.EV_BATCH_NPZ:
                batch = wire.decode_batch(payload)
                batch.drops = int(header.get("drops", 0))
                batch.seq = int(header.get("batch_seq", 0))
                self.collect.batches += 1
                self.collect.events += batch.count
                if self._batch_handler is not None and batch.count:
                    self._batch_handler(batch)
            elif t == wire.EV_SUMMARY:
                if header.get("digest"):
                    self.collect.recorded_digests.append(header["digest"])
                inst = self._sketch_instance()
                if inst is not None and getattr(inst, "enabled", False):
                    inst.harvest()  # flows through alerts + our collector
            elif t == wire.EV_ALERT:
                self.collect.recorded_alerts.append(
                    dict(header.get("alert") or {}))
            # EV_JOURNAL_MARK and anything unknown: position-only records
        self.collect.losses = [dataclasses.asdict(loss)
                               for loss in self.reader.losses]


class _ReplayDesc(GadgetDesc):
    """Deliberately NOT registered: replay is a verb, not a catalog
    gadget (registering it would drift docs/gadgets.md and the doctor
    report with an entry no capture window backs)."""

    name = "journal"
    category = "replay"
    gadget_type = GadgetType.TRACE
    description = "internal journal replay gadget"
    event_cls = None

    def __init__(self, reader: JournalReader, clock: ReplayClock,
                 speed: float, collect: ReplayResult):
        self._reader = reader
        self._clock = clock
        self._speed = speed
        self._collect = collect

    def params(self) -> ParamDescs:
        return ParamDescs()

    def new_instance(self, ctx: GadgetContext) -> _ReplayGadget:
        return _ReplayGadget(ctx, self._reader, self._clock, self._speed,
                             self._collect)


# params a replay must not inherit from the recorded run: capture would
# recurse the journal into itself, the webhook file would double-append,
# and the wall-clock harvest interval would fight the recorded
# boundaries (EV_SUMMARY records drive harvests instead)
_STRIP_PARAM_PREFIXES = ("operator.capture.",)
_STRIP_PARAMS = ("operator.alerts.webhook-file",)
_FORCE_PARAMS = {"operator.tpusketch.harvest-interval": "1h"}


def _replay_op_params(manifest: dict, desc: GadgetDesc,
                      overrides: dict[str, str] | None) -> Collection:
    """Reconstruct the recorded run's operator chain from the manifest's
    resolved params (the provenance contract), minus the self-referential
    bits, plus caller overrides."""
    from ..operators import operators as op_registry
    flat = {k: v for k, v in (manifest.get("params") or {}).items()
            if not any(k.startswith(p) for p in _STRIP_PARAM_PREFIXES)
            and k not in _STRIP_PARAMS}
    flat.update(_FORCE_PARAMS)
    flat.update(overrides or {})
    col = Collection({
        f"operator.{op.name}.": op.instance_params().to_params()
        for op in op_registry.get_all() if op.can_operate_on(desc)
    })
    col.copy_from_map(flat)
    return col


def replay_journal(path: str, *, speed: float = 0.0,
                   rules: str | None = None,
                   rules_file: str | None = None,
                   param_overrides: dict[str, str] | None = None,
                   dry_run_alerts: bool = False,
                   on_summary: Callable[[dict], None] | None = None,
                   on_alert: Callable[[dict], None] | None = None,
                   timeout: float = 0.0,
                   device: str = "cuda") -> ReplayResult:
    """Replay one journal through the real operator chain; returns the
    ReplayResult with the determinism evidence (digests + transitions,
    recorded and replayed). `rules`/`rules_file` replace the recorded
    alert rules (the `alerts test --journal` path); `speed` 0 = as fast
    as possible, 1 = recorded pace. `device` holds the replay's sketch
    state (``cuda`` raises where there is no card)."""
    from .. import all_gadgets  # noqa: F401 — operators register
    from ..runtime.local import LocalRuntime

    reader = JournalReader(path)
    clock = ReplayClock()
    collect = ReplayResult(
        journal=path, records=0, batches=0, events=0, summaries=[],
        digests=[], recorded_digests=[], alerts=[], recorded_alerts=[],
        losses=[], manifest=reader.manifest)
    desc = _ReplayDesc(reader, clock, speed, collect)

    overrides = dict(param_overrides or {})
    if rules is not None:
        overrides["operator.alerts.rules"] = rules
        overrides["operator.alerts.rules-file"] = ""
    if rules_file is not None:
        overrides["operator.alerts.rules-file"] = rules_file
        overrides["operator.alerts.rules"] = ""

    def collect_summary(summary):
        d = summary_to_dict(summary)
        collect.summaries.append(d)
        collect.digests.append(summary_digest(d))
        if on_summary is not None:
            on_summary(d)

    def collect_alert(alert: dict):
        collect.alerts.append(dict(alert))
        if on_alert is not None:
            on_alert(dict(alert))

    ctx = GadgetContext(
        desc,
        operator_params=_replay_op_params(reader.manifest, desc, overrides),
        timeout=timeout,
        device=device,
        extra={
            "replay": True,
            "alerts_clock": clock.now,
            "alerts_dry_run": dry_run_alerts,
            "on_sketch_summary": collect_summary,
            "on_alert_event": collect_alert,
            "node": reader.manifest.get("node", "") or "replay",
            # windows resealed during replay keep the RECORDED gadget
            # identity, so their content digests reproduce the live run's
            "history_gadget": reader.manifest.get("gadget", "") or None,
        },
    )
    result = LocalRuntime(node_name="replay").run_gadget(ctx)
    errs = result.errors()
    if errs:
        raise RuntimeError(f"replay of {path} failed: {errs}")
    return collect


def iter_journals(path: str) -> Iterator[str]:
    """Yield journal directories under `path`: the path itself when it is
    a journal, else every immediate child journal (a recording dir or a
    fetched bundle node dir), else every node's journals one level down
    (a fetched bundle root)."""
    import os

    from .journal import is_journal
    if is_journal(path):
        yield path
        return
    found = False
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
        child = os.path.join(path, name)
        if is_journal(child):
            found = True
            yield child
    if found:
        return
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
        child = os.path.join(path, name)
        if os.path.isdir(child):
            for j in sorted(os.listdir(child)):
                jpath = os.path.join(child, j)
                if is_journal(jpath):
                    yield jpath


__all__ = ["ReplayClock", "ReplayResult", "ReplaySource", "iter_journals",
           "replay_journal"]
