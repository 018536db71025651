"""Capture plane: the durable segmented event journal (`capture.journal`)
the sealed-window history store is built on. The recording manager, the
capture operator and replay wait for their ROADMAP item."""

from .journal import (JOURNAL_SCHEMA, JournalReader, JournalWriter, SegmentLoss, build_manifest,
                      capture_base_dir, is_journal, summary_digest, summary_to_dict)

__all__ = ["JOURNAL_SCHEMA", "JournalReader", "JournalWriter", "SegmentLoss", "build_manifest",
           "capture_base_dir", "is_journal", "summary_digest", "summary_to_dict"]
