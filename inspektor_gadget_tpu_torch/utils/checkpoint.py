"""Sketch-state checkpoint files (the port's counterpart of
``inspektor_gadget_tpu/utils/checkpoint.py``).

The reference flattens a pytree and writes its leaves as ``leaf_{i}`` of
one compressed ``.npz``, beside a ``__treedef__`` entry and a ``.json``
sidecar. The port has no pytrees: callers hand over the leaves already
in the reference's flatten order (`ops.sketches.bundle_to_numpy` for a
bundle), and this module writes the same ``leaf_{i}`` layout with the
same atomic rename. It writes no ``__treedef__`` and a sidecar without
a ``treedef`` key, so the reference's ``load_pytree`` checks a
port-written file by its leaf count (``utils/checkpoint.py:67-78``
there); reading a reference-written file, the port ignores the treedef
string and checks leaf count and shapes against ``like``. A checkpoint
written by either package so resumes in the other.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Sequence

import numpy as np


def save_pytree(path: str | Path, leaves: Sequence[np.ndarray]) -> None:
    """Atomic save of `leaves` to ``<path>.npz`` (and a ``.json``
    sidecar): the archive is written under a temporary name unique to
    this process and thread, then renamed over the old one, so a crash
    mid-write never leaves a torn file and concurrent savers of one key
    never interleave."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
    tmp_npz = path.with_suffix(f".npz{tag}")
    with open(tmp_npz, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp_npz, path.with_suffix(".npz"))
    try:  # for human inspection only; load trusts the archive
        path.with_suffix(".json").write_text(json.dumps({"n_leaves": len(arrays)}))
    except OSError:
        pass


def load_pytree(path: str | Path, like: Sequence[np.ndarray] | None = None) -> list[np.ndarray]:
    """The leaves of ``<path>.npz`` in order. With `like`, the count and
    each leaf's shape must match it (a different configuration raises
    ValueError), and each leaf is cast to the dtype of its `like`
    counterpart."""
    path = Path(path)
    with np.load(str(path.with_suffix(".npz"))) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    if like is None:
        return leaves
    if len(leaves) != len(like):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(like)}")
    out = []
    for i, (got, want) in enumerate(zip(leaves, like)):
        want = np.asarray(want)
        if got.shape != want.shape:
            raise ValueError(f"checkpoint leaf {i}: shape {got.shape}, expected {want.shape}")
        out.append(got.astype(want.dtype, copy=False))
    return out
