"""The port's native capture leg on the CPU: its own build of the C++
capture library and its ctypes binding, against the JAX package's.

The port builds ``inspektor_gadget_tpu_torch/native/`` with g++ into
``build/native/`` and writes nothing under ``inspektor_gadget_tpu/``; a
broken source or a missing compiler raises. For the same seed its
`generate_folded` and `pop_folded` (values lane included, into a pinned
pool block) give the lanes the reference's `NativeCapture` gives, and
the threaded capture's stream is the one `generate` rebuilds from the
seed, which is how ``chip_smoke.py`` holds the card's fold of it. The
reference library is reached as tests/test_sources.py reaches it.
"""

from __future__ import annotations

import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.sources.bridge import NativeCapture as RefCapture
from inspektor_gadget_tpu.sources.bridge import native_available
from inspektor_gadget_tpu_torch import native
from inspektor_gadget_tpu_torch.ops.hashing import fold64_to_32
from inspektor_gadget_tpu_torch.sources import PinnedBufferPool
from inspektor_gadget_tpu_torch.sources import bridge as B

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "inspektor_gadget_tpu"
# the reference's own build products, which its tests may write meanwhile
REFERENCE_BUILD = {"libigcapture.so", "syscall_names.inc", "ring_stress", "ring_stress_tsan",
                   "source_stress_tsan"}


@pytest.fixture
def reference_capture():
    """The reference's NativeCapture, or a skip where its library is
    missing (decided in the test, not while the file is imported)."""
    if not native_available():
        pytest.skip("no reference native lib")
    return RefCapture


def _snapshot() -> dict:
    out = {}
    for p in REFERENCE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts and p.name not in REFERENCE_BUILD:
            st = p.stat()
            out[str(p)] = (st.st_size, st.st_mtime_ns)
    return out


def _git_status() -> str | None:
    try:
        proc = subprocess.run(["git", "status", "--porcelain", "--", "inspektor_gadget_tpu"],
                              cwd=ROOT, capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return proc.stdout if proc.returncode == 0 else None


def test_port_builds_its_own_library_under_build(tmp_path):
    """A fresh build (into a new build directory, so it really compiles)
    leaves the JAX package as it was; the port's library lives under
    build/native/ and is named by the hash of its sources and flags."""
    before, git_before = _snapshot(), _git_status()
    lib = native.HostLibrary(B._bind, build_dir=tmp_path / "native")
    lib.get()
    assert lib.path.parent == tmp_path / "native" and lib.path.name.startswith("libigcapture-")
    assert (tmp_path / "native" / "syscall_names.inc").read_text().count("{") > 100
    assert _snapshot() == before and _git_status() == git_before
    assert lib.path.name == B.LIBRARY.library_path().name  # same sources, same flags
    B.LIBRARY.get()
    assert B.LIBRARY.path.parent == ROOT / "build" / "native"
    assert native.NATIVE_DIR == ROOT / "inspektor_gadget_tpu_torch" / "native"
    assert {p.name for p in native.NATIVE_DIR.iterdir()} >= {"api.cc", "events.h", "ringbuf.h"}


def test_broken_build_and_missing_compiler_raise(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(native.NATIVE_DIR, src)
    with open(src / "api.cc", "a") as f:
        f.write("\n#error a broken source\n")
    broken = native.HostLibrary(B._bind, source_dir=src, build_dir=tmp_path / "b1")
    with pytest.raises(RuntimeError, match="broken source"):
        broken.get()
    assert not any(p.suffix == ".so" for p in (tmp_path / "b1").iterdir())
    missing = native.HostLibrary(B._bind, build_dir=tmp_path / "b2",
                                 cxx=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        missing.get()
    unbindable = native.HostLibrary(lambda lib: lib.ig_no_such_symbol,
                                    build_dir=B.LIBRARY.build_dir)
    with pytest.raises(RuntimeError, match="cannot load or bind"):
        unbindable.get()


@pytest.mark.parametrize("kind", [B.SRC_SYNTH_EXEC, B.SRC_SYNTH_TCP, B.SRC_SYNTH_DNS])
def test_generate_folded_matches_reference(kind, reference_capture):
    port = B.NativeCapture(kind, seed=11, vocab=700)
    ref = reference_capture(kind, seed=11, vocab=700)
    for n in (1, 4097, 20000):
        assert np.array_equal(port.generate_folded(n), ref.generate_folded(n))
    out = np.zeros(10, np.uint32)
    with pytest.raises(ValueError):
        port.generate_folded(11, out)
    b = port.generate(500)
    assert port.vocab_lookup(int(b.cols["key_hash"][0])).startswith("proc-")
    names = port.vocab_lookup_batch(b.cols["key_hash"][:5])
    assert names == ref.vocab_lookup_batch(b.cols["key_hash"][:5])
    port.close()
    ref.close()


def _capture(cls, seed: int, vocab: int):
    src = cls(B.SRC_SYNTH_EXEC, seed=seed, rate=100_000, vocab=vocab, ring_pow2=16)
    src.start()
    time.sleep(0.15)
    src.stop()
    return src


def _drain(src, block, arr) -> list[np.ndarray]:
    out = []
    while True:
        fb = src.pop_folded(block, with_values=True)
        if fb.count == 0:
            return out
        assert fb.has_values and fb.values is not None
        assert getattr(fb, "block", None) is (block if isinstance(block, torch.Tensor) else None)
        out.append(arr[:, :fb.count].copy())


def test_pop_folded_with_values_matches_reference_and_the_seed(reference_capture):
    """The threaded capture into a pinned pool block (through its
    .numpy() view) gives the reference's lanes for the same seed, and
    its keys and mntns are the stream `generate` rebuilds from it."""
    port, ref = _capture(B.NativeCapture, 5, 300), _capture(reference_capture, 5, 300)
    pool = PinnedBufferPool(4096, lanes=4, device="cpu")
    block = pool.get()
    got = np.concatenate(_drain(port, block, block.numpy()), axis=1)
    ref_block = np.zeros((4, 4096), np.uint32)
    want = np.concatenate(_drain(ref, ref_block, ref_block), axis=1)
    n = min(got.shape[1], want.shape[1])
    assert n > 4096 and port.drops() == 0 and port.produced() == got.shape[1]
    assert np.array_equal(got[:, :n], want[:, :n])
    assert (got[1] == 1).all() and (got[3] == 0).all()  # weights 1; exec events carry no value
    rebuilt = B.NativeCapture(B.SRC_SYNTH_EXEC, seed=5, vocab=300).generate(got.shape[1])
    assert np.array_equal(got[0], fold64_to_32(rebuilt.cols["key_hash"]))
    assert np.array_equal(got[2], fold64_to_32(rebuilt.cols["mntns"]))
    with pytest.raises(ValueError):
        port.pop_folded(torch.zeros((4, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        port.pop_folded(np.zeros((3, 16), np.uint32), with_values=True)
    with pytest.raises(ValueError):  # rows that are not contiguous
        port.pop_folded(np.zeros((16, 4), np.uint32).T, with_values=True)
    port.set_filter([])
    assert port.filtered() == 0
    port.set_filter(None)
    port.close()
    ref.close()



def test_drain_synthetic_hands_over_the_seed_stream():
    """`drain_synthetic` runs the capture until it made `total` events,
    drains the ring into the blocks `get_block` gives, drops nothing, and
    what it hands over is the stream `synthetic_stream` rebuilds; the
    block of the last empty pop goes back through `release`."""
    pool = PinnedBufferPool(2048, lanes=4, device="cpu")
    lanes, released = [], []

    def on_batch(blk, fb):
        assert fb.count > 0 and fb.block is blk
        lanes.append(fb.lanes[:, :fb.count].copy())
        pool.put(blk)

    got = B.drain_synthetic(B.SRC_SYNTH_EXEC, 9, 300, 20000, pool.get, on_batch,
                            release=released.append)
    cat = np.concatenate(lanes, axis=1)
    assert got["drops"] == 0 and got["consumed"] == got["produced"] == cat.shape[1] >= 20000
    assert got["source_s"] > 0 and len(released) == 1
    keys, mntns = B.synthetic_stream(B.SRC_SYNTH_EXEC, 9, 300, cat.shape[1])
    assert keys.dtype == mntns.dtype == np.uint32
    assert np.array_equal(cat[0], keys) and np.array_equal(cat[2], mntns)
    assert (cat[1] == 1).all()
