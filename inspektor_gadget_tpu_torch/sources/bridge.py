"""ctypes binding of the native capture library (the port's copy of
``inspektor_gadget_tpu/sources/bridge.py``).

The library is the port's own build of ``native/`` (`native.HostLibrary`,
into ``build/native/``), made at the first call that needs it, never at
import. A missing compiler, a failed build or a failed load raises; the
reference returns None instead and degrades.

`NativeCapture.pop_folded` drains a capture ring straight into the rows
of a uint32 block with one native call: the port's pinned pool blocks
(torch tensors) are filled in place through their ``.numpy()`` view, so
the lanes the C++ exporter writes are the H2D staging buffer.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..native import HostLibrary
from ..ops.hashing import fold64_to_32
from .batch import EventBatch, FoldedBatch

SRC_SYNTH_EXEC = 1
SRC_SYNTH_TCP = 2
SRC_SYNTH_DNS = 3
SRC_PROC_EXEC = 100
SRC_PROC_TCP = 101
SRC_FANOTIFY_EXEC = 102
SRC_FANOTIFY_OPEN = 103
SRC_MOUNTINFO = 104
SRC_SOCK_DIAG = 105
SRC_KMSG_OOM = 106
SRC_PTRACE = 108
SRC_FANOTIFY_RUNC = 109
SRC_PERF_CPU = 110
SRC_BLK_TRACE = 111
SRC_TCP_BYTES = 112
SRC_AUDIT = 113
SRC_CAP_TRACE = 114
SRC_FS_TRACE = 115
SRC_SOCK_STATE = 116
SRC_SIG_TRACE = 117
SRC_PKT_DNS = 200
SRC_PKT_SNI = 201
SRC_PKT_FLOW = 202

# kinds that take a "key=value\x1f..." config string (ig_source_create_cfg)
_CFG_KINDS = {SRC_FANOTIFY_OPEN, SRC_MOUNTINFO, SRC_SOCK_DIAG, SRC_KMSG_OOM,
              SRC_PTRACE, SRC_FANOTIFY_RUNC, SRC_PERF_CPU, SRC_BLK_TRACE,
              SRC_TCP_BYTES, SRC_AUDIT, SRC_CAP_TRACE, SRC_FS_TRACE,
              SRC_SOCK_STATE, SRC_SIG_TRACE}

# the event kind generate() stamps for each synthetic source
_SYNTH_EVENT_KIND = {SRC_SYNTH_EXEC: 1, SRC_SYNTH_TCP: 4, SRC_SYNTH_DNS: 7}


def make_cfg(**kw) -> str:
    """The config string of a cfg-kind source; a list value is joined
    with \\x1e."""
    parts = []
    for k, v in kw.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            v = "\x1e".join(str(x) for x in v)
        parts.append(f"{k}={v}")
    return "\x1f".join(parts)


def _bind(lib: ctypes.CDLL) -> None:
    u64, u32, i64, f64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64, ctypes.c_double
    p64, p32 = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)
    lib.ig_source_create.argtypes = [u32, u64, f64, u32, f64, u32]
    lib.ig_source_create.restype = u64
    lib.ig_source_create_cfg.argtypes = [u32, ctypes.c_char_p, u32]
    lib.ig_source_create_cfg.restype = u64
    lib.ig_source_set_filter.argtypes = [u64, p64, i64]
    lib.ig_source_set_filter.restype = ctypes.c_int
    lib.ig_source_filtered.argtypes = [u64]
    lib.ig_source_filtered.restype = u64
    for fn in ("ig_source_start", "ig_source_stop", "ig_source_destroy"):
        getattr(lib, fn).argtypes = [u64]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ig_source_pop_folded.argtypes = [u64, i64, p32, p32, p32]
    lib.ig_source_pop_folded.restype = i64
    lib.ig_source_pop_folded2.argtypes = [u64, i64, p32, p32, p32, p32]
    lib.ig_source_pop_folded2.restype = i64
    lib.ig_source_drops.argtypes = [u64]
    lib.ig_source_drops.restype = u64
    lib.ig_source_produced.argtypes = [u64]
    lib.ig_source_produced.restype = u64
    lib.ig_synth_generate.argtypes = [u64, i64, p64, p64, p32, p32]
    lib.ig_synth_generate.restype = i64
    lib.ig_synth_generate_folded.argtypes = [u64, i64, p32]
    lib.ig_synth_generate_folded.restype = i64
    lib.ig_vocab_lookup.argtypes = [u64, u64, ctypes.c_char_p, i64]
    lib.ig_vocab_lookup.restype = i64
    lib.ig_vocab_lookup_batch.argtypes = [u64, p64, i64, ctypes.c_char_p, i64,
                                          ctypes.POINTER(ctypes.c_int32)]
    lib.ig_vocab_lookup_batch.restype = i64


LIBRARY = HostLibrary(_bind)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _as_block(block) -> tuple[np.ndarray, torch.Tensor | None]:
    """(numpy view, tensor or None) of a uint32 block: a pool block's
    tensor is filled in place through its .numpy() view."""
    if isinstance(block, torch.Tensor):
        if block.dtype != torch.uint32 or block.device.type != "cpu":
            raise ValueError(f"a folded block is a host uint32 tensor, got {block.dtype} "
                             f"on {block.device}")
        return block.numpy(), block
    return block, None


class NativeCapture:
    """A native capture source: folded blocks popped from its ring, or
    synthetic events generated on the caller's thread."""

    def __init__(self, kind: int, *, seed: int = 0, rate: float = 0.0, vocab: int = 1000,
                 zipf_s: float = 1.2, ring_pow2: int = 20, cfg: str = ""):
        self._lib = LIBRARY.get()
        if kind in _CFG_KINDS:
            self._h = self._lib.ig_source_create_cfg(kind, cfg.encode("utf-8", "replace"),
                                                     ring_pow2)
        else:
            self._h = self._lib.ig_source_create(kind, seed, rate, vocab, zipf_s, ring_pow2)
        if self._h == 0:
            raise ValueError(f"unknown source kind {kind}")
        self.kind = kind
        self._seq = 0
        self._last_pop_ts = 0.0  # the folded path's oldest_ts upper bound

    def start(self) -> None:
        self._lib.ig_source_start(self._h)

    def stop(self) -> None:
        self._lib.ig_source_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ig_source_destroy(self._h)
            self._h = 0

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        # stop capture, keep the handle: its vocab stays resolvable until close()
        self.stop()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to report to
            pass

    def pop_folded(self, block, with_values: bool = False) -> FoldedBatch:
        """Drain the ring into a (3+, capacity) uint32 block (a pinned pool
        block or a numpy array): keys, weights and mntns lanes with one
        native call (`ig_source_pop_folded`); with `with_values` the block
        needs a 4th row and `ig_source_pop_folded2` fills it with each
        event's magnitude."""
        arr, tensor = _as_block(block)
        need = 4 if with_values else 3
        if (arr.ndim != 2 or arr.shape[0] < need or arr.dtype != np.uint32
                or arr.strides[1] != arr.itemsize):
            raise ValueError(f"pop_folded needs a ({need}, capacity) uint32 block with "
                             f"contiguous rows")
        if with_values:
            got = self._lib.ig_source_pop_folded2(self._h, arr.shape[1], _p32(arr[0]),
                                                  _p32(arr[1]), _p32(arr[2]), _p32(arr[3]))
        else:
            got = self._lib.ig_source_pop_folded(self._h, arr.shape[1], _p32(arr[0]),
                                                 _p32(arr[1]), _p32(arr[2]))
        if got < 0:
            raise RuntimeError("pop_folded on destroyed source")
        now = time.time()
        fb = FoldedBatch(lanes=arr, count=int(got), seq=self._seq, drops=self.drops(),
                         has_values=with_values, pop_ts=now,
                         oldest_ts=self._last_pop_ts or now, block=tensor)
        self._seq += int(got)
        self._last_pop_ts = now
        return fb

    def generate(self, n: int) -> EventBatch:
        """Synchronous synthetic generation (no capture thread)."""
        b = EventBatch.alloc(n, with_comm=False)
        c = b.cols
        got = self._lib.ig_synth_generate(self._h, n, _p64(c["key_hash"]), _p64(c["mntns"]),
                                          _p32(c["pid"]), _p32(c["uid"]))
        if got < 0:
            raise RuntimeError("generate on non-synthetic source")
        b.count = int(got)
        c["kind"][: b.count] = _SYNTH_EVENT_KIND.get(self.kind, self.kind)
        c["ts"][: b.count] = np.uint64(time.time_ns())
        b.pop_ts = b.oldest_ts = time.time()
        self._last_pop_ts = b.pop_ts
        return b

    def generate_folded(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Synchronous generation of n xor-folded uint32 keys into `out`
        (a buffer too small for n keys raises)."""
        if out is None:
            out = np.empty(n, dtype=np.uint32)
        elif out.size < n or out.dtype != np.uint32 or not out.flags.c_contiguous:
            raise ValueError(f"generate_folded needs a uint32 buffer of >= {n} entries, "
                             f"got {out.dtype}[{out.size}]")
        got = self._lib.ig_synth_generate_folded(self._h, n, _p32(out))
        if got < 0:
            raise RuntimeError("generate_folded on non-synthetic source")
        return out[:got]

    def drops(self) -> int:
        return int(self._lib.ig_source_drops(self._h))

    def produced(self) -> int:
        return int(self._lib.ig_source_produced(self._h))

    def set_filter(self, mntns_ids) -> None:
        """Install the capture-side mntns filter (None clears it; an empty
        one blocks everything)."""
        if mntns_ids is None:
            self._lib.ig_source_set_filter(
                self._h, ctypes.cast(None, ctypes.POINTER(ctypes.c_uint64)), 0)
            return
        arr = np.fromiter(mntns_ids, dtype=np.uint64)
        if arr.size == 0:
            self._lib.ig_source_set_filter(self._h, _p64(np.zeros(1, np.uint64)), 0)
            return
        self._lib.ig_source_set_filter(self._h, _p64(arr), arr.size)

    def filtered(self) -> int:
        return int(self._lib.ig_source_filtered(self._h))

    def vocab_lookup(self, key_hash: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.ig_vocab_lookup(self._h, key_hash, buf, 256)
        return buf.raw[:n].decode("utf-8", "replace") if n > 0 else ""

    def vocab_lookup_batch(self, keys, stride: int = 256) -> list[str]:
        """Un-hash many keys with one native call."""
        keys64 = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys64.size
        if n == 0:
            return []
        out = ctypes.create_string_buffer(n * stride)
        lens = np.zeros(n, dtype=np.int32)
        r = self._lib.ig_vocab_lookup_batch(self._h, _p64(keys64), n, out, stride,
                                            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if r < 0:
            return [""] * n
        raw = out.raw
        return [raw[i * stride:i * stride + ln].decode("utf-8", "replace") if ln > 0 else ""
                for i, ln in enumerate(lens.tolist())]


def drain_synthetic(kind: int, seed: int, vocab: int, total: int, get_block, on_batch,
                    release=None) -> dict:
    """Run a synthetic NativeCapture of `kind` (rate 2e8 events/s) until
    it has made `total` events, then drain its ring. Each pop fills
    `get_block()` with the value lane and hands every non-empty
    FoldedBatch to `on_batch(block, fb)`; an empty pop keeps its block
    for the next one, and the last such block goes to `release(block)`.
    The ring holds the whole run, so nothing drops and what was consumed
    is the seed's stream from its start, `generate` rebuilds it. Returns
    the events consumed, made and dropped, the `time.perf_counter()` at
    which capture started, and the seconds the source took from then to
    make `total` (the capture thread's rate)."""
    cap = NativeCapture(kind, seed=seed, rate=2e8, vocab=vocab,
                        ring_pow2=max(20, (total + (1 << 21)).bit_length()))
    consumed, made_s, blk = 0, None, None
    cap.start()
    t0 = time.perf_counter()
    try:
        while True:
            if made_s is None and cap.produced() >= total:
                cap.stop()  # joins the capture thread: the ring holds the rest
                made_s = time.perf_counter() - t0
            blk = get_block() if blk is None else blk
            fb = cap.pop_folded(blk, with_values=True)
            if fb.count == 0:
                if made_s is not None:
                    break
                time.sleep(0.0002)
                continue
            on_batch(blk, fb)
            blk, consumed = None, consumed + fb.count
        return {"consumed": consumed, "produced": cap.produced(), "drops": cap.drops(),
                "started": t0, "source_s": made_s}
    finally:
        if blk is not None and release is not None:
            release(blk)
        cap.stop()
        cap.close()


def synthetic_stream(kind: int, seed: int, vocab: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The first `n` events of a synthetic source's seeded stream, folded
    as `pop_folded` folds them -> (keys, mntns) uint32 lanes."""
    src = NativeCapture(kind, seed=seed, vocab=vocab)
    try:
        ev = src.generate(n)
    finally:
        src.close()
    return fold64_to_32(ev.cols["key_hash"]), fold64_to_32(ev.cols["mntns"])
