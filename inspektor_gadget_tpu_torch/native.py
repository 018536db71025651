"""Build and bind the port's native sources.

Each CUDA source in ``csrc/`` is its own shared library with a plain C
interface: built at first use by nvcc into ``build/kernels/`` at the
repository root, named by a hash of the source and its flags (so an
edited source is rebuilt), and loaded with ctypes. `build_all` starts
one nvcc per source, all at once, so a run that needs every kernel
waits for the slowest build only.

The C++ capture layer in ``native/`` (the JAX package's, copied as it
is but for the proc connector's event codes in ``sources.cc``, which
newer kernel headers spell differently, and the bind source's procfs
scan of TCP listeners in ``watchers.cc``, for hosts whose sock_diag
answers no TCP dump) is one more such library,
`HostLibrary`: built by g++ with the flags of the reference's Makefile
into ``build/native/``, named by a hash of every source and the flags,
with the ``syscall_names.inc`` it includes generated into the build
directory from the toolchain's ``<asm/unistd.h>``. A missing compiler,
a failed build or a failed load raises; nothing is built or written
outside ``build/``.

Also here: the checks every kernel wrapper shares (which device its
tensors are on, the CUDA error a launch returns, the current stream).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Callable, Iterable
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NATIVE_DIR = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class CudaLibrary:
    """One ``csrc/`` source built into its own library, loaded once per
    process. `bind` sets the argtypes and restype of its entries."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: tuple[str, ...] = ()) -> None:
        self.source = CSRC_DIR / source
        self.flags = BASE_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._mu = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_log = ""
        self.build_seconds = 0.0

    def library_path(self) -> Path:
        """Where the library of the source as it is now, with these
        flags, is (or will be) built."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source with nvcc (once per source and flag set)
        and return the library's path; nvcc's output (ptxas' registers
        and spills) is kept beside it and read back for a built one."""
        out = self.library_path()
        log = out.with_suffix(".log")
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *self.flags, "-o", str(tmp), str(self.source)],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                               f"{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._mu:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(str(self.path))
                self._bind(lib)
                self._lib = lib
            return self._lib


def _write_atomically(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def syscall_names(cxx: str) -> bytes:
    """The ``{nr, "name"},`` rows of syscall_names.inc: every ``__NR_*``
    macro with a number that the toolchain's <asm/unistd.h> defines (the
    reference Makefile's recipe)."""
    proc = subprocess.run([cxx, "-E", "-dM", "-x", "c++", "-"], input="#include <asm/unistd.h>\n",
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} could not read <asm/unistd.h>:\n{proc.stderr}")
    rows = []
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[1].startswith("__NR_") and parts[2].isdigit():
            rows.append(f'{{{parts[2]}, "{parts[1][5:]}"}},\n')
    return "".join(rows).encode()


class HostLibrary:
    """The capture layer's C++ sources built by g++ into one library
    (``api.cc`` includes the rest), loaded once per process. `bind` sets
    the argtypes and restype of its entries; `source_dir`, `build_dir`
    and `cxx` (default $CXX, else g++) let a test build elsewhere."""

    def __init__(self, bind: Callable[[ctypes.CDLL], None], *,
                 source_dir: Path = NATIVE_DIR, build_dir: Path = HOST_BUILD_DIR,
                 cxx: str | None = None) -> None:
        self.source_dir = Path(source_dir)
        self.build_dir = Path(build_dir)
        self.cxx = cxx
        self._bind = bind
        self._mu = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds = 0.0

    def sources(self) -> list[Path]:
        return sorted(p for p in self.source_dir.iterdir()
                      if p.suffix in (".cc", ".h") and p.is_file())

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        for p in self.sources():
            h.update(p.name.encode() + b"\0" + p.read_bytes())
        return self.build_dir / f"libigcapture-{h.hexdigest()[:16]}.so"

    def _compiler(self) -> str:
        cxx = self.cxx or os.environ.get("CXX") or shutil.which("g++")
        if not cxx or shutil.which(cxx) is None:
            raise RuntimeError(f"C++ compiler {cxx or 'g++'!r} not found: the native "
                               f"capture library cannot be built")
        return cxx

    def build(self) -> Path:
        """Compile the sources (once per source and flag set) and return
        the library's path."""
        out = self.library_path()
        if out.exists():
            return out
        cxx = self._compiler()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        _write_atomically(self.build_dir / "syscall_names.inc", syscall_names(cxx))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *HOST_FLAGS, "-I", str(self.build_dir), "-o", str(tmp),
                               str(self.source_dir / "api.cc")],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on api.cc ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._mu:
            if self._lib is None:
                path = self.build()
                try:
                    lib = ctypes.CDLL(str(path))
                    self._bind(lib)
                except (OSError, AttributeError) as e:
                    raise RuntimeError(f"cannot load or bind {path}: {e}") from e
                self.path = path
                self._lib = lib
            return self._lib

    def loaded(self) -> ctypes.CDLL | None:
        """The library if this process has loaded it, else None (never
        builds)."""
        with self._mu:
            return self._lib


def build_all(libs: Iterable[CudaLibrary | HostLibrary]) -> None:
    """Build and load every library in `libs`, one compiler each, all
    started together; raises the first build's error after all have
    ended."""
    errors: list[BaseException] = []

    def one(lib: CudaLibrary | HostLibrary) -> None:
        try:
            lib.get()
        except Exception as e:  # re-raised below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=one, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def on_cpu(*xs: torch.Tensor | None) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors
    (the kernel); raises for any other mix."""
    devs = {x.device.type for x in xs if x is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devs)}: a kernel takes CUDA tensors, "
                     "its plain version CPU tensors")
