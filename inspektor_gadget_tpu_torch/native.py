"""Build and bind the port's CUDA sources.

Each source in ``csrc/`` is its own shared library with a plain C
interface: built at first use by nvcc into ``build/kernels/`` at the
repository root, named by a hash of the source and its flags (so an
edited source is rebuilt), and loaded with ctypes. `build_all` starts
one nvcc per source, all at once, so a run that needs every kernel
waits for the slowest build only.

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


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build and load every library in `libs`, one nvcc each, all started
    together; raises the first build's error after all have ended."""
    errors: list[BaseException] = []

    def one(lib: CudaLibrary) -> None:
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
