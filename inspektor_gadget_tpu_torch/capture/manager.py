"""RecordingManager — the node-wide recording lifecycle.

The capture operator rides every gadget run (like tpusketch), but a
journal is only written when something armed it: either the run itself
(`--capture-dir` on the operator) or a node-wide *recording* started
here — by the agent's StartRecording RPC, by `ig-tpu record start`
against a local process, or programmatically in tests. A recording is a
directory `<base>/<recording-id>/` that accumulates one journal per
(gadget run) teeing into it:

    <base>/<recording-id>/
      recording.json             # id, started/stopped, per-journal stats
      <node>--<run_id>/          # one capture journal per recorded run
        manifest.json  index.jsonl  seg-*.igj

StopRecording seals every journal and finalizes recording.json; the
GrpcRuntime's fetch fan-out then pulls each node's recording directory
into one client-side bundle. The process-wide singleton (RECORDINGS)
plays the role tpusketch's checkpoint-dir global plays for sketch state.

The port's copy of ``inspektor_gadget_tpu/capture/manager.py``; a
journal's manifest records the torch device type of the run it tees
(``platform``). The agent serves it over its recording RPCs
(`agent.service`), and `GrpcRuntime.fetch_recording` pulls every node's
journals into one bundle.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..utils.journal import read_json_file
from .journal import JournalReader, JournalWriter, build_manifest, capture_base_dir, is_journal

RECORDING_META = "recording.json"


def validate_recording_id(recording_id: str) -> str:
    """One id check every path-resolving entry point shares: the agent's
    recording RPCs resolve `<base>/<id>` for ids a CLIENT sent, so a
    separator, a '..' component, or an absolute id would escape the
    capture area entirely (os.path.join discards the base on an absolute
    component). Raises ValueError; returns the id for chaining."""
    if (not recording_id
            or recording_id != os.path.basename(recording_id)
            or recording_id in (".", "..")):
        raise ValueError(f"bad recording id {recording_id!r}")
    return recording_id


class Recording:
    def __init__(self, recording_id: str, path: str, opts: dict):
        self.id = recording_id
        self.path = path
        self.opts = dict(opts)
        self.started_ts = time.time()
        self._writers: dict[str, JournalWriter] = {}   # journal key → writer
        self._mu = threading.Lock()

    def writer_for(self, *, node: str, gadget: str, run_id: str,
                   params: dict[str, str] | None = None,
                   platform: str = "unprobed") -> JournalWriter:
        """The (lazily-opened) journal for one recorded run."""
        key = f"{node or 'local'}--{run_id}"
        with self._mu:
            w = self._writers.get(key)
            if w is None:
                w = JournalWriter(
                    os.path.join(self.path, key),
                    manifest=build_manifest(
                        journal_id=f"{self.id}/{key}", node=node,
                        gadget=gadget, run_id=run_id, params=params,
                        platform=platform, extra={"recording_id": self.id}),
                    **{k: v for k, v in self.opts.items()
                       if k in ("max_segment_bytes", "max_segment_age",
                                "retention_bytes", "retention_segments")},
                )
                w.mark("recording-start", recording=self.id, node=node,
                       gadget=gadget, run_id=run_id)
                self._writers[key] = w
        return w

    def release(self, *, node: str, run_id: str) -> None:
        """A recorded run finished: seal and close its journal."""
        key = f"{node or 'local'}--{run_id}"
        with self._mu:
            w = self._writers.pop(key, None)
        if w is not None:
            w.mark("run-end", recording=self.id, run_id=run_id)
            w.close()

    def stop(self) -> dict:
        with self._mu:
            writers = list(self._writers.items())
            self._writers.clear()
        journals = {}
        for key, w in writers:
            w.mark("recording-stop", recording=self.id)
            journals[key] = w.close()
        meta = {
            "id": self.id,
            "started_ts": self.started_ts,
            "stopped_ts": time.time(),
            "journals": sorted(
                d for d in os.listdir(self.path)
                if os.path.isdir(os.path.join(self.path, d))),
            "opts": self.opts,
        }
        tmp = os.path.join(self.path, f"{RECORDING_META}.tmp.{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f, sort_keys=True)
        os.replace(tmp, os.path.join(self.path, RECORDING_META))
        return meta

    def describe(self) -> dict:
        with self._mu:
            open_journals = {k: w.stats() for k, w in self._writers.items()}
        return {"id": self.id, "path": self.path, "state": "recording",
                "started_ts": self.started_ts,
                "open_journals": open_journals}


class RecordingManager:
    def __init__(self):
        self._mu = threading.Lock()
        self._active: dict[str, Recording] = {}
        self._base: str | None = None

    # -- configuration ------------------------------------------------------

    def set_base_dir(self, path: str | None) -> None:
        """Agent --capture-dir / test override of the default area."""
        with self._mu:
            self._base = path or None

    def base_dir(self) -> str:
        with self._mu:
            return capture_base_dir(self._base)

    # -- lifecycle ----------------------------------------------------------

    def start(self, recording_id: str, *, base_dir: str | None = None,
              **opts) -> Recording:
        path = self.recording_dir(validate_recording_id(recording_id),
                                  base_dir)
        with self._mu:
            if recording_id in self._active:
                raise ValueError(f"recording {recording_id!r} already active")
            if os.path.exists(os.path.join(path, RECORDING_META)):
                raise ValueError(
                    f"recording {recording_id!r} already exists at {path}")
            os.makedirs(path, exist_ok=True)
            rec = Recording(recording_id, path, opts)
            self._active[recording_id] = rec
        return rec

    def stop(self, recording_id: str) -> dict:
        with self._mu:
            rec = self._active.pop(recording_id, None)
        if rec is None:
            raise KeyError(f"recording {recording_id!r} is not active")
        return rec.stop()

    def stop_all(self) -> list[dict]:
        with self._mu:
            recs = list(self._active.values())
            self._active.clear()
        return [r.stop() for r in recs]

    def active(self) -> list[Recording]:
        with self._mu:
            return list(self._active.values())

    def get(self, recording_id: str) -> Recording | None:
        with self._mu:
            return self._active.get(recording_id)

    def recording_dir(self, recording_id: str,
                      base_dir: str | None = None) -> str:
        """Resolve `<base>/<id>` for a VALIDATED id — the RPC layer hands
        client-supplied ids straight here, so the check is not optional."""
        return os.path.join(base_dir or self.base_dir(),
                            validate_recording_id(recording_id))

    # -- inspection ---------------------------------------------------------

    def list(self, base_dir: str | None = None) -> list[dict]:
        """Active recordings plus finished ones found on disk."""
        out = [r.describe() for r in self.active()]
        seen = {r["id"] for r in out}
        base = base_dir or self.base_dir()
        if os.path.isdir(base):
            for name in sorted(os.listdir(base)):
                if name in seen:
                    continue
                meta, _err = read_json_file(
                    os.path.join(base, name, RECORDING_META))
                if meta is not None:
                    out.append({**meta, "path": os.path.join(base, name),
                                "state": "stopped"})
        return out

    def inspect(self, recording_id: str,
                base_dir: str | None = None) -> dict:
        """Per-journal stats of one (active or stopped) recording."""
        path = self.recording_dir(recording_id, base_dir)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no recording at {path}")
        journals = {}
        for name in sorted(os.listdir(path)):
            jpath = os.path.join(path, name)
            if is_journal(jpath):
                journals[name] = JournalReader(jpath).stats()
        meta, _err = read_json_file(os.path.join(path, RECORDING_META))
        state = ("recording" if self.get(recording_id) is not None
                 else "stopped" if meta is not None else "unknown")
        return {"id": recording_id, "path": path, "state": state,
                "meta": meta, "journals": journals}


# the process-wide singleton every capture operator instance consults
RECORDINGS = RecordingManager()

__all__ = ["RECORDINGS", "RECORDING_META", "Recording", "RecordingManager"]
