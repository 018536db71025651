"""Sketch history plane: sealed windows and their merge algebra (numpy
only). The sealed-window store the reference appends to
(``inspektor_gadget_tpu/history/store.py``) waits for its ROADMAP item;
the tpusketch operator hands each sealed window to a ``window_sink``."""

from .window import (SLICE_ENT_LOG2_WIDTH, SLICE_HH_K, SLICE_HLL_P, WINDOW_SCHEMA,
                     MergedWindows, SealedWindow, SliceSketch, decode_window, encode_window,
                     entropy_bits, header_overlaps, merge_windows, merged_to_sealed,
                     provenance_row, slice_hll_estimate, window_digest)

__all__ = ["MergedWindows", "SLICE_ENT_LOG2_WIDTH", "SLICE_HH_K", "SLICE_HLL_P",
           "SealedWindow", "SliceSketch", "WINDOW_SCHEMA", "decode_window", "encode_window",
           "entropy_bits", "header_overlaps", "merge_windows", "merged_to_sealed",
           "provenance_row", "slice_hll_estimate", "window_digest"]
