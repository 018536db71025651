"""The port's copies of the capture layer's stress harnesses
(``native/ring_stress.cc``, ``native/source_stress.cc``), built by g++
through `native.StressHarness` into ``build/native/`` and run: plain
(-O2) and under ThreadSanitizer, the counterparts of the reference
Makefile's ``stress``, ``tsan`` and ``tsan-sources`` targets. The TSAN
builds run wherever g++ takes ``-fsanitize=thread``; the source harness
opens the kernel windows, which needs root. The doctor's
``native_toolchain`` row reports the facts these skips read
(tests/test_native_build.py's case).
"""

from __future__ import annotations

import functools
import os
import shutil
import threading
from pathlib import Path

import pytest

from inspektor_gadget_tpu_torch import native
from inspektor_gadget_tpu_torch.doctor import probe_windows

ROOT = Path(__file__).resolve().parent.parent
BUILDS = [(name, tsan) for name in ("ring_stress", "source_stress") for tsan in (False, True)]


@functools.lru_cache(maxsize=None)
def _toolchain() -> tuple[str | None, bool]:
    """(the C++ compiler or None, whether it takes -fsanitize=thread),
    found when a test first asks, never while the file is imported."""
    cxx = native.cxx_path()
    return cxx, bool(cxx) and native.tsan_supported(cxx)


def _skip_reason(name: str, tsan: bool) -> str | None:
    cxx, has_tsan = _toolchain()
    if cxx is None:
        return "no C++ compiler: see the doctor's native_toolchain row"
    if tsan and not has_tsan:
        return f"{cxx} rejects -fsanitize=thread: see the doctor's native_toolchain row"
    if name == "source_stress" and os.geteuid() != 0:
        return "source_stress opens the kernel windows: needs root"
    return None


@pytest.fixture(scope="module")
def built():
    """Every harness this host can build, built at once (one g++ each)."""
    out = {}

    def one(name, tsan):
        try:
            h = native.StressHarness(name, tsan)
            h.build()
            out[name, tsan] = h
        except Exception as e:  # re-raised by the test that needs it
            out[name, tsan] = e

    threads = [threading.Thread(target=one, args=b) for b in BUILDS if _skip_reason(*b) is None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_doctor_reports_the_toolchain_row():
    """The skip conditions above and the doctor's row agree."""
    w = probe_windows()["native_toolchain"]
    cxx, has_tsan = _toolchain()
    nvcc = native.nvcc_path()
    assert w.ok == bool(cxx and nvcc and native.nvcc_has_sm90a(nvcc))
    if cxx:
        assert f"{os.path.basename(cxx)} present" in w.detail
        assert ("tsan ok" if has_tsan else "no -fsanitize=thread") in w.detail
    else:
        assert "missing" in w.detail
    assert ("nvcc present" if nvcc else "missing nvcc") in w.detail


@pytest.mark.parametrize("name,tsan", BUILDS,
                         ids=[f"{n}-{'tsan' if t else 'plain'}" for n, t in BUILDS])
def test_harness_builds_and_passes(name, tsan, built):
    reason = _skip_reason(name, tsan)
    if reason:
        pytest.skip(reason)
    h = built[name, tsan]
    if isinstance(h, Exception):
        raise h
    path = h.binary_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert path.name.startswith(f"{name}{'_tsan' if tsan else ''}-")
    r = h.run(timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "ThreadSanitizer" not in r.stderr
    assert f"{name.replace('_', ' ')} OK" in r.stdout
    if name == "ring_stress":
        fields = dict(kv.split("=") for kv in r.stdout.split("\n")[0].split())
        assert int(fields["produced"]) == 2_000_000 == int(fields["consumed"]) + int(
            fields["dropped"])


def test_a_broken_source_raises_and_builds_nothing(tmp_path):
    if _toolchain()[0] is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src)
    (src / "ring_stress.cc").write_text("int main() { return undefined_symbol; }\n")
    h = native.StressHarness("ring_stress", source_dir=src, build_dir=tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on ring_stress.cc"):
        h.build()
    assert not h.binary_path().exists()


def test_the_binary_is_named_by_its_sources_and_flags(tmp_path):
    plain = native.StressHarness("ring_stress")
    tsan = native.StressHarness("ring_stress", tsan=True)
    assert plain.binary_path() != tsan.binary_path()
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src)
    assert native.StressHarness("ring_stress", source_dir=src).binary_path().name == \
        plain.binary_path().name
    (src / "ringbuf.h").write_text((src / "ringbuf.h").read_text() + "\n// edited\n")
    assert native.StressHarness("ring_stress", source_dir=src).binary_path().name != \
        plain.binary_path().name


def test_the_copies_are_the_references_but_for_their_build_notes():
    """The harnesses' code is the reference's: only the comment lines
    that say how they are built differ."""
    for name in ("ring_stress.cc", "source_stress.cc"):
        ref = (ROOT / "inspektor_gadget_tpu" / "native" / name).read_text().splitlines()
        got = (native.NATIVE_DIR / name).read_text().splitlines()
        code = [ln for ln in got if not ln.startswith("//")]
        assert code == [ln for ln in ref if not ln.startswith("//")], name
