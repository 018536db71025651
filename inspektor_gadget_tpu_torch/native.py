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

The capture layer's stress harnesses (``native/ring_stress.cc``, the
ring's producer/consumer conservation; ``native/source_stress.cc``,
concurrent create/start/pop/filter/stats/stop across the kernel-window
sources, which needs root) build the same way into ``build/native/``
(`StressHarness`): a plain ``-O2`` build, and a ThreadSanitizer build
where g++ takes ``-fsanitize=thread`` (`tsan_supported`), the
counterparts of the reference Makefile's ``stress``, ``tsan`` and
``tsan-sources`` targets.

Also here: the checks every kernel wrapper shares (which device its
tensors are on, the CUDA error a launch returns, the current stream).
"""

from __future__ import annotations

import ctypes
import functools
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
        nvcc = nvcc_path()
        if nvcc is None:
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


def _gxx(cxx: str | None, flags: tuple[str, ...], source: Path, source_dir: Path,
         build_dir: Path, out: Path) -> float:
    """Compile `source` with g++ (`cxx`, default $CXX, else g++) and
    `flags` into `out`, with ``syscall_names.inc`` generated into
    `build_dir` and both directories on the include path; a missing
    compiler or a failed build raises and leaves no output. Returns the
    build's seconds."""
    compiler = cxx_path(cxx)
    if compiler is None:
        raise RuntimeError(f"C++ compiler {cxx or os.environ.get('CXX') or 'g++'!r} not found: "
                           f"{source.name} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    _write_atomically(build_dir / "syscall_names.inc", syscall_names(compiler))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-I", str(source_dir), "-I", str(build_dir),
                           "-o", str(tmp), str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return seconds


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

    def build(self) -> Path:
        """Compile the sources (once per source and flag set) and return
        the library's path."""
        out = self.library_path()
        if not out.exists():
            self.build_seconds = _gxx(self.cxx, HOST_FLAGS, self.source_dir / "api.cc",
                                      self.source_dir, self.build_dir, out)
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


def cxx_path(cxx: str | None = None) -> str | None:
    """The C++ compiler the capture layer builds with ($CXX, else g++),
    or None where it is missing."""
    return shutil.which(cxx or os.environ.get("CXX") or "g++")


def nvcc_path() -> str | None:
    """nvcc on the PATH or under /usr/local/cuda, or None."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return nvcc if os.path.exists(nvcc) else None


@functools.lru_cache(maxsize=None)
def nvcc_has_sm90a(nvcc: str) -> bool:
    """Whether `nvcc` compiles an empty kernel for ``sm_90a`` (tried once
    per process, in a temporary directory): what the kernels' build
    asks of it."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ig-sm90a-") as d:
        src = Path(d) / "k.cu"
        src.write_text("__global__ void k() {}\n")
        try:
            proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-cubin",
                                   "-o", str(Path(d) / "k.cubin"), str(src)],
                                  capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        return proc.returncode == 0


@functools.lru_cache(maxsize=None)
def tsan_supported(cxx: str) -> bool:
    """Whether `cxx` compiles and links a program with
    ``-fsanitize=thread`` (tried once per process, in a temporary
    directory)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ig-tsan-") as d:
        src = Path(d) / "t.cc"
        src.write_text("int main() { return 0; }\n")
        try:
            proc = subprocess.run([cxx, "-fsanitize=thread", "-o", str(Path(d) / "t"), str(src)],
                                  capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        return proc.returncode == 0


STRESS_FLAGS = {False: ("-O2", "-std=c++17", "-pthread"),
                True: ("-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread")}


class StressHarness:
    """One of the capture layer's stress programs (``ring_stress`` or
    ``source_stress``), built by g++ into `build_dir` (plain, or under
    ThreadSanitizer with `tsan`) and run."""

    def __init__(self, name: str, tsan: bool = False, *, source_dir: Path = NATIVE_DIR,
                 build_dir: Path = HOST_BUILD_DIR, cxx: str | None = None) -> None:
        self.name, self.tsan = name, tsan
        self.source_dir, self.build_dir = Path(source_dir), Path(build_dir)
        self.cxx = cxx
        self.flags = STRESS_FLAGS[tsan]
        self.build_seconds = 0.0

    def binary_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for p in sorted(self.source_dir.iterdir()):
            if p.suffix in (".cc", ".h") and p.is_file():
                h.update(p.name.encode() + b"\0" + p.read_bytes())
        suffix = "_tsan" if self.tsan else ""
        return self.build_dir / f"{self.name}{suffix}-{h.hexdigest()[:16]}"

    def build(self) -> Path:
        """Compile (once per source and flag set) and return the binary;
        a missing compiler, or `tsan` where g++ rejects it, raises."""
        out = self.binary_path()
        if not out.exists():
            cxx = cxx_path(self.cxx)
            if self.tsan and cxx and not tsan_supported(cxx):
                raise RuntimeError(f"{cxx} rejects -fsanitize=thread: no TSAN build of "
                                   f"{self.name}")
            self.build_seconds = _gxx(self.cxx, self.flags,
                                      self.source_dir / f"{self.name}.cc", self.source_dir,
                                      self.build_dir, out)
        return out

    def get(self) -> Path:
        """`build`: so `build_all` builds harnesses beside libraries."""
        return self.build()

    def run(self, timeout: float = 600.0) -> subprocess.CompletedProcess:
        """Build if needed, run, and return the finished process (its
        exit code is the harness's verdict; ThreadSanitizer exits 66 on a
        race)."""
        return subprocess.run([str(self.build())], capture_output=True, text=True,
                              timeout=timeout)


def build_all(libs: Iterable[CudaLibrary | HostLibrary | StressHarness]) -> None:
    """Build (and load) every library or harness in `libs`, one compiler
    each, all started together; raises the first build's error after all
    have ended."""
    errors: list[BaseException] = []

    def one(lib: CudaLibrary | HostLibrary | StressHarness) -> None:
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
