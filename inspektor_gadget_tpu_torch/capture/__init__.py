"""Capture/replay plane: durable segmented event journals
(`capture.journal`, which the sealed-window history store is built on),
the node-wide recording lifecycle (`capture.manager`, armed by the
capture operator riding every run), and deterministic replay of any
journal through the port's operator chain on an injectable clock
(`capture.replay`).

The port's copy of ``inspektor_gadget_tpu/capture/``: journals move
between the two packages in either direction.
"""

from .journal import (JOURNAL_SCHEMA, JournalReader, JournalWriter, SegmentLoss, build_manifest,
                      capture_base_dir, is_journal, summary_digest, summary_to_dict)
from .manager import RECORDINGS, Recording, RecordingManager
from .replay import ReplayClock, ReplayResult, ReplaySource, iter_journals, replay_journal

__all__ = ["JOURNAL_SCHEMA", "JournalReader", "JournalWriter", "RECORDINGS", "Recording",
           "RecordingManager", "ReplayClock", "ReplayResult", "ReplaySource", "SegmentLoss",
           "build_manifest", "capture_base_dir", "is_journal", "iter_journals", "replay_journal",
           "summary_digest", "summary_to_dict"]
