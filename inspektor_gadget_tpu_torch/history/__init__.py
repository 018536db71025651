"""Sketch history plane (the port's copy of ``inspektor_gadget_tpu/history``,
numpy and file I/O only): sealed windows and their merge algebra
(window.py), the per-node sealed-window store (store.py), range queries
over it (query.py), time-decayed compaction (lifecycle.py) and the
archive tier (archive.py). The bytes on disk are the reference's, so
either package reads, compacts, archives and merges the other's store.
"""

from .archive import (ARCHIVE_MANIFEST, ARCHIVE_SCHEMA, ArchiveBackend, ArchiveTier,
                      FilesystemArchive)
from .lifecycle import (DEFAULT_SCHEDULE, CompactionEngine, ScheduleLevel, parse_schedule,
                        validate_schedule)
from .query import (QueryAnswer, answer_query, decode_frames, dedupe_compacted, level_counts,
                    pack_frames, unpack_frames)
from .store import (HISTORY, HISTORY_METRICS, HISTORY_SCHEMA, HistoryStore, history_base_dir,
                    validate_store_name)
from .window import (SLICE_ENT_LOG2_WIDTH, SLICE_HH_K, SLICE_HLL_P, WINDOW_SCHEMA,
                     MergedWindows, SealedWindow, SliceSketch, decode_window, encode_window,
                     entropy_bits, header_overlaps, merge_windows, merged_to_sealed,
                     provenance_row, slice_hll_estimate, window_digest)

__all__ = [
    "ARCHIVE_MANIFEST", "ARCHIVE_SCHEMA", "ArchiveBackend", "ArchiveTier", "CompactionEngine",
    "DEFAULT_SCHEDULE", "FilesystemArchive", "HISTORY", "HISTORY_METRICS", "HISTORY_SCHEMA",
    "HistoryStore", "MergedWindows", "QueryAnswer", "SLICE_ENT_LOG2_WIDTH", "SLICE_HH_K",
    "SLICE_HLL_P", "ScheduleLevel", "SealedWindow", "SliceSketch", "WINDOW_SCHEMA",
    "answer_query", "decode_frames", "decode_window", "dedupe_compacted", "encode_window",
    "entropy_bits", "header_overlaps", "history_base_dir", "level_counts", "merge_windows",
    "merged_to_sealed", "pack_frames", "parse_schedule", "provenance_row",
    "slice_hll_estimate", "unpack_frames", "validate_schedule", "validate_store_name",
    "window_digest",
]
