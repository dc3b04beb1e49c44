"""Build a CUDA source of the port with ``nvcc`` and load it with ``ctypes``.

Each kernel source under ``omldm_tpu_torch/csrc/`` has a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes). It is compiled
for ``sm_90a`` into ``build/omldm_tpu_torch/`` at the repository root, named
by a hash of the source, every shared header (``csrc/*.cuh``) and the flags,
so a changed source or header is rebuilt and an unchanged one is reused.

:meth:`KernelLibrary.start` launches ``nvcc`` in the background and
:meth:`KernelLibrary.load` waits for it, so a caller can start every build
at once and wait for each when it first needs it; :meth:`KernelLibrary.stop`
ends one never waited for. ``load`` alone builds synchronously.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "omldm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


class KernelLibrary:
    """One source file, built once per content and loaded once per process.

    ``configure`` sets the ``argtypes``/``restype`` of the library's C
    functions after it is loaded. ``source`` is a file name under ``csrc/``
    (or an absolute path)."""

    def __init__(self, source: str, configure: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._configure = configure
        #: seconds nvcc took in this process (0.0 when a built library was reused)
        self.build_seconds = 0.0
        #: nvcc's output (the -Xptxas -v register / shared-memory / spill report)
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._t0 = 0.0
        self._tmp: Optional[Path] = None

    def _target(self) -> Path:
        """The library's path: a hash of the source, every header beside it
        (a source may include any of them) and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start(self) -> None:
        """Launch nvcc in the background unless the library is built."""
        if self._lib is not None or self._proc is not None:
            return
        out = self._target()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def stop(self) -> None:
        """End a build that :meth:`start` launched and nothing waited for
        (a caller leaving before it needed the library); a no-op otherwise."""
        if self._proc is None:
            return
        self._proc.kill()
        self._proc.wait()
        self._proc = None
        if self._tmp is not None:
            self._tmp.unlink(missing_ok=True)

    def load(self) -> ctypes.CDLL:
        """Wait for (or run) the build, then load and configure the library."""
        if self._lib is not None:
            return self._lib
        self.start()
        out = self._target()
        if self._proc is not None:
            log, _ = self._proc.communicate()
            self.build_seconds = time.perf_counter() - self._t0
            self.build_log = log
            rc, self._proc = self._proc.returncode, None
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n{log}")
            os.replace(self._tmp, out)
        lib = ctypes.CDLL(str(out))
        self._configure(lib)
        self._lib = lib
        return lib
