"""Shared append-only JSON-lines discipline: atomic appends, torn-tail
tolerant reads (the port's copy of ``inspektor_gadget_tpu/utils/journal.py``).

The capture journal's segment *index*, the history store's index and the
archive manifest use it (the binary segment framing itself lives in
capture/journal.py, built on the same append discipline).

Append contract: one record = one compact JSON line, written with a
single `os.write` on an O_APPEND fd — POSIX makes that atomic between
processes, so concurrent writers cannot interleave bytes. A rare short
write is completed in a loop or raised, never reported as success.

Read contract: a crash mid-append leaves at most one torn line at the
tail. Readers never fail the whole file for it — `on_bad="stop"` treats
the first unparseable line as the torn tail (everything before it is
good), `on_bad="skip"` reports and skips every unusable line (the
ledger's stance: interior corruption must not take the history down).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable


@dataclasses.dataclass
class JsonlRead:
    records: list[dict]
    skipped: list[str]          # 'line N: why' for unusable lines


def append_line(path: str, obj: Any, *, mode: int = 0o644) -> None:
    """Serialize `obj` to ONE compact JSON line and append it atomically
    (single O_APPEND write; short writes completed or raised)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(obj, sort_keys=True, separators=(",", ":")) + "\n"
    append_bytes(path, line.encode("utf-8"), mode=mode)


def append_bytes(path: str, buf: bytes, *, mode: int = 0o644) -> None:
    """The raw O_APPEND single-write discipline (capture segment frames
    reuse it for binary records)."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, mode)
    try:
        while buf:  # a short write must not report success on a torn tail
            n = os.write(fd, buf)
            if n <= 0:
                raise OSError(f"short write appending to {path}")
            buf = buf[n:]
    finally:
        os.close(fd)


def read_jsonl(path: str, *, on_bad: str = "stop",
               validate: Callable[[dict], str | None] | None = None
               ) -> JsonlRead:
    """All parseable records in append order, tolerating a torn tail.

    on_bad="stop": an unparseable line IS the torn tail — stop there
    (the webhook-sink stance). on_bad="skip": report and skip every
    unusable line, keep reading (the ledger stance). `validate` returns
    an error string for records that parse but are unusable; those are
    always skipped-and-reported, never fatal.
    """
    if on_bad not in ("stop", "skip"):
        raise ValueError(f"on_bad must be 'stop' or 'skip', got {on_bad!r}")
    records: list[dict] = []
    skipped: list[str] = []
    if not os.path.exists(path):
        return JsonlRead(records, skipped)
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                skipped.append(f"line {i}: unparseable ({e.msg})")
                if on_bad == "stop":
                    break  # torn tail — everything before it is good
                continue
            if validate is not None:
                err = validate(rec)
                if err:
                    skipped.append(f"line {i}: invalid ({err})")
                    continue
            records.append(rec)
    return JsonlRead(records, skipped)


def read_json_file(path: str) -> tuple[dict | None, str]:
    """(document, "") or (None, why) for a whole-file JSON artifact that
    may be crash-truncated (flight-recorder dumps): unreadable or torn
    files are reported, never raised — a post-mortem read must not crash
    on the very evidence of the crash."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        return None, f"{path}: unreadable ({e.strerror or e})"
    except json.JSONDecodeError as e:
        return None, f"{path}: truncated or corrupt ({e.msg} at line {e.lineno})"
    if not isinstance(doc, dict):
        return None, f"{path}: not a JSON object"
    return doc, ""


__all__ = ["JsonlRead", "append_bytes", "append_line", "read_json_file",
           "read_jsonl"]
