"""Declarative JSON event matching for black-box tests.

Ref: integration/helpers.go — parseMultiJSONOutput:31, parseJSONArrayOutput:53,
ExpectEntriesToMatch:150 (each expected entry must appear among the parsed,
normalized entries), ExpectEntriesInArrayToMatch:160 (line-per-array form used
by interval gadgets), BuildCommonData:178. Normalization zeroes fields the
test cannot predict (pids, timestamps, node names) so exact-equality
subset matching works.

The port's copy of ``inspektor_gadget_tpu/testing/match.py``.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable


Normalize = Callable[[dict], None]


def parse_multi_json(output: str, normalize: Normalize | None = None) -> list[dict]:
    """One JSON object per line (streaming gadget `-o json` output)."""
    entries = []
    for line in output.splitlines():
        line = line.strip()
        if not line:
            continue
        entry = json.loads(line)
        if normalize is not None:
            normalize(entry)
        entries.append(entry)
    return entries


def parse_json_array(output: str, normalize: Normalize | None = None) -> list[dict]:
    """A single JSON array (one-shot snapshot gadgets), or one array per
    line (interval gadgets re-emitting each tick)."""
    output = output.strip()
    entries: list[dict] = []
    if output.startswith("["):
        arrays = [json.loads(ln) for ln in output.splitlines() if ln.strip()]
    else:
        arrays = [json.loads(output)]
    for arr in arrays:
        for entry in arr:
            if normalize is not None:
                normalize(entry)
            entries.append(entry)
    return entries


def _subset_match(expected: dict, got: dict) -> bool:
    return all(got.get(k) == v for k, v in expected.items())


def _expect(entries: list[dict], expected: Iterable[dict]) -> None:
    for exp in expected:
        if not any(_subset_match(exp, e) for e in entries):
            sample = json.dumps(entries[:5], indent=1, default=str)
            raise AssertionError(
                f"no entry matches {json.dumps(exp, default=str)};\n"
                f"got {len(entries)} entries, first 5:\n{sample}")


def expect_entries_to_match(output: str, normalize: Normalize | None,
                            *expected: dict) -> None:
    """Every expected entry appears in the line-per-event output."""
    _expect(parse_multi_json(output, normalize), expected)


def expect_entries_in_array_to_match(output: str, normalize: Normalize | None,
                                     *expected: dict) -> None:
    """Every expected entry appears in the JSON-array output."""
    _expect(parse_json_array(output, normalize), expected)


def expect_all_entries_to_match(output: str, normalize: Normalize | None,
                                expected: dict) -> None:
    """Every emitted entry matches the expected subset (negative-filter
    tests: e.g. everything carries the requested container name)."""
    entries = parse_multi_json(output, normalize)
    if not entries:
        raise AssertionError("no entries emitted")
    for e in entries:
        if not _subset_match(expected, e):
            raise AssertionError(
                f"entry {json.dumps(e, default=str)} does not match "
                f"{json.dumps(expected, default=str)}")


def build_common_data(node: str = "", namespace: str = "",
                      pod: str = "", container: str = "") -> dict:
    """CommonData subset for expectations (ref: helpers.go:178-189,
    pkg/types/types.go:73-120)."""
    d: dict = {}
    if node:
        d["node"] = node
    if namespace:
        d["namespace"] = namespace
    if pod:
        d["pod"] = pod
    if container:
        d["container"] = container
    return d
