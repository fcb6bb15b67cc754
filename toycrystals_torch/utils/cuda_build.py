"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `toycrystals_torch/csrc/<name>.cu` has a plain C interface. It is
compiled at first use into `toycrystals_torch/_build/<name>-<hash>.so` (the
hash covers the source and the flags, so an edited source rebuilds) and
loaded once per process. A source that is specialised at compile time
(csrc/flash_attn.cu: one head dim per build) is built once per tuple of
`-D` defines, each into a library of its own. Nothing here runs at import
time: this module is imported on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built")


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile csrc/<name>.cu, with `-D<define>` for each of `defines`, into
    the build directory; return the .so path.

    Raises RuntimeError with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} {list(defines)}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    log = out.with_suffix(".log")
    log.write_text(proc.stdout + proc.stderr)
    return out


def build_all(targets: list[str | tuple[str, tuple[str, ...]]]) -> list[Path]:
    """Build several libraries at once, one nvcc process each. A target is a
    source name or (name, defines)."""
    pairs = [(t, ()) if isinstance(t, str) else t for t in targets]
    with ThreadPoolExecutor(max_workers=max(1, len(pairs))) as ex:
        return list(ex.map(lambda nd: build(*nd), pairs))


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu with `defines`, built on first use."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            lib = _libs[(name, defines)] = ctypes.CDLL(str(build(name, defines)))
        return lib
