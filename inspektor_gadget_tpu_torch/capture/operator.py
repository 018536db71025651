"""Capture operator — tees the live pipeline into durable journals.

Rides every gadget run like tpusketch does, but stays a no-op until
armed: either the run itself sets `--capture-dir` (a run-scoped journal)
or a node-wide recording is active (RecordingManager — the agent's
StartRecording RPC / `ig-tpu record start`). When armed, the instance
appends to each destination journal:

- every decoded EventBatch that leaves the enrich chain (EV_BATCH_NPZ,
  the same npz framing the agent streams),
- every harvested sketch summary with its determinism digest
  (EV_SUMMARY — these double as the replay plane's harvest boundaries),
- every alert transition (EV_ALERT — the recorded ground truth the
  replay e2e compares against),
- lifecycle marks (EV_JOURNAL_MARK).

Replay runs set ctx.extra["replay"]; the operator refuses to re-record
them (a replay teeing into an active recording would recurse the
journal into itself).

The port's copy of ``inspektor_gadget_tpu/capture/operator.py``: the
same records in the same journal format, so either package replays the
other's journals. The manifest's ``platform`` is the run's device type.
"""

from __future__ import annotations

import os
from typing import Any

from ..agent import wire
from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..params import ParamDesc, ParamDescs, Params, TypeHint
from ..utils.logger import get_logger
from .journal import (
    DEFAULT_RETENTION_BYTES,
    DEFAULT_SEGMENT_AGE,
    DEFAULT_SEGMENT_BYTES,
    JournalWriter,
    build_manifest,
    summary_digest,
    summary_to_dict,
)
from ..operators.operators import Operator, OperatorInstance, register
from .manager import RECORDINGS

log = get_logger("ig-tpu.capture")


def _resolved_params(ctx: GadgetContext) -> dict[str, str]:
    """The run's resolved flat param map — the manifest provenance a
    replay reconstructs its operator chain from."""
    flat = ctx.gadget_params.copy_to_map(prefix="gadget.")
    flat.update(ctx.operator_params.copy_to_map())
    return flat


class Capture(Operator):
    name = "capture"

    def dependencies(self) -> list[str]:
        return []

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        return True  # any batch-emitting gadget can be recorded

    def instance_params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="dir", default="",
                      description="record this run into a journal under "
                                  "this directory (independent of node-"
                                  "wide recordings)"),
            ParamDesc(key="max-segment-bytes",
                      default=str(DEFAULT_SEGMENT_BYTES),
                      type_hint=TypeHint.INT,
                      description="rotate the active segment at this size"),
            ParamDesc(key="max-segment-age", default=f"{DEFAULT_SEGMENT_AGE}s",
                      type_hint=TypeHint.DURATION,
                      description="rotate the active segment at this age"),
            ParamDesc(key="retention-bytes",
                      default=str(DEFAULT_RETENTION_BYTES),
                      type_hint=TypeHint.INT,
                      description="GC oldest sealed segments beyond this "
                                  "total size (0 = unlimited)"),
            ParamDesc(key="retention-segments", default="0",
                      type_hint=TypeHint.INT,
                      description="GC oldest sealed segments beyond this "
                                  "count (0 = unlimited)"),
            ParamDesc(key="summaries", default="true",
                      type_hint=TypeHint.BOOL,
                      description="record harvested sketch summaries"),
            ParamDesc(key="alerts", default="true", type_hint=TypeHint.BOOL,
                      description="record alert transitions"),
        ])

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "CaptureInstance":
        return CaptureInstance(self, ctx, instance_params)


class CaptureInstance(OperatorInstance):
    def __init__(self, op: Capture, ctx: GadgetContext, params: Params):
        super().__init__(op.name)
        self.ctx = ctx
        self._run_writer: JournalWriter | None = None
        self._replay = bool(ctx.extra.get("replay"))
        p = params
        self._opts = {
            "max_segment_bytes": (p.get("max-segment-bytes").as_int()
                                  if "max-segment-bytes" in p
                                  else DEFAULT_SEGMENT_BYTES),
            "max_segment_age": (p.get("max-segment-age").as_duration()
                                if "max-segment-age" in p
                                else DEFAULT_SEGMENT_AGE),
            "retention_bytes": (p.get("retention-bytes").as_int()
                                if "retention-bytes" in p
                                else DEFAULT_RETENTION_BYTES),
            "retention_segments": (p.get("retention-segments").as_int()
                                   if "retention-segments" in p else 0),
        }
        self._want_summaries = (p.get("summaries").as_bool()
                                if "summaries" in p else True)
        self._want_alerts = (p.get("alerts").as_bool()
                             if "alerts" in p else True)
        run_dir = p.get("dir").as_string() if "dir" in p else ""
        self._node = ctx.extra.get("node", "") or ""
        self._params = _resolved_params(ctx)  # once, not per batch
        self._platform = str(ctx.device).partition(":")[0]
        if run_dir and not self._replay:
            self._run_writer = JournalWriter(
                os.path.join(run_dir, f"{ctx.desc.full_name.replace('/', '-')}"
                                      f"-{ctx.run_id}"),
                manifest=build_manifest(
                    journal_id=ctx.run_id, node=self._node,
                    gadget=ctx.desc.full_name, run_id=ctx.run_id,
                    params=self._params, platform=self._platform),
                **self._opts)
            self._run_writer.mark("run-start", gadget=ctx.desc.full_name,
                                  run_id=ctx.run_id)
        # chain into the summary path. The alerts operator DEPENDS on
        # capture (alertsop.dependencies), so capture instantiates first
        # and its hook sits innermost: the engine evaluates each harvest
        # before this hook records it, and — because teardown runs in
        # reverse — the engine's end-of-run resolves still find these
        # writers open
        if self._want_summaries and not self._replay:
            prev = ctx.extra.get("on_sketch_summary")

            def hook(summary):
                self._record_summary(summary)
                if prev is not None:
                    prev(summary)

            ctx.extra["on_sketch_summary"] = hook
        if self._want_alerts and not self._replay:
            prev_alert = ctx.extra.get("on_alert_event")

            def alert_hook(alert: dict):
                self._record_alert(alert)
                if prev_alert is not None:
                    prev_alert(alert)

            ctx.extra["on_alert_event"] = alert_hook

    # -- destinations -------------------------------------------------------

    def _writers(self) -> list[JournalWriter]:
        writers = []
        if self._run_writer is not None:
            writers.append(self._run_writer)
        if not self._replay:
            for rec in RECORDINGS.active():
                try:
                    writers.append(rec.writer_for(
                        node=self._node, gadget=self.ctx.desc.full_name,
                        run_id=self.ctx.run_id, params=self._params,
                        platform=self._platform))
                except (OSError, ValueError) as e:
                    log.warning("recording %s: journal open failed: %r",
                                rec.id, e)
        return writers

    @staticmethod
    def _append(writers: list[JournalWriter], ev_type: int, header: dict,
                payload: bytes = b"") -> None:
        for w in writers:
            try:
                w.append(ev_type, header, payload)
            except (OSError, ValueError) as e:
                log.warning("capture append to %s failed: %r", w.path, e)

    # -- the tee points -----------------------------------------------------

    def enrich_batch(self, batch: Any) -> None:
        if self._replay or batch.count == 0:
            return
        writers = self._writers()
        if not writers:
            return
        self._append(writers, wire.EV_BATCH_NPZ,
                     {"count": batch.count, "drops": batch.drops,
                      "batch_seq": batch.seq},
                     wire.encode_batch(batch))

    def _record_summary(self, summary) -> None:
        writers = self._writers()
        if not writers:
            return
        header, payload = wire.encode_summary(summary)
        header["digest"] = summary_digest(summary_to_dict(summary))
        self._append(writers, wire.EV_SUMMARY, header, payload)

    def _record_alert(self, alert: dict) -> None:
        writers = self._writers()
        if not writers:
            return
        self._append(writers, wire.EV_ALERT, {"alert": alert})

    def post_gadget_run(self) -> None:
        if self._run_writer is not None:
            self._run_writer.mark("run-end", run_id=self.ctx.run_id)
            self._run_writer.close()
            self._run_writer = None
        if not self._replay:
            for rec in RECORDINGS.active():
                rec.release(node=self._node, run_id=self.ctx.run_id)


register(Capture())
