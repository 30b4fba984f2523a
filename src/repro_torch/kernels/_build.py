"""Build and load the port's CUDA kernels (route (b): ``nvcc`` by hand
into a shared library with a plain C interface, loaded with ``ctypes``).

Every ``csrc/*.cu`` compiles at first use, one ``nvcc`` process per
source, all started together, for ``sm_90a`` (``wgmma`` and
``setmaxnreg`` exist only for the ``a`` target); ``csrc/*.cuh`` are
headers the sources include.  A library is named by the hash of its
source, the headers and the flags, so an edited source is rebuilt and
an unchanged one is loaded from ``build/kernels/`` (gitignored) as it
is.  nvcc's output (ptxas's register counts and warnings) is kept beside
each library as ``<library>.log`` and read back into ``BUILD_LOG`` when
the library is loaded from there.
Nothing here runs at import: ``import repro_torch`` needs no compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # source stem -> nvcc/ptxas output
BUILD_SECONDS: Dict[str, float] = {}  # source stem -> its nvcc's wall time


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what sources include
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel;
    returns stem -> library path.  Raises with nvcc's output on failure."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for src in sources():
        lib = _lib_path(src)
        out[src.stem] = lib
        kept_log = lib.with_suffix(".log")
        if lib.exists() and kept_log.exists():
            BUILD_LOG[src.stem] = kept_log.read_text()
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log_path = lib.with_suffix(f".{os.getpid()}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT)
        procs[src.stem] = (proc, tmp, lib, log_path)
    failed = []
    # poll, so that each source's wall time is its own; the output goes to
    # a file, so no full pipe can stall a compiler that is not being read
    pending = dict(procs)
    while pending:
        for stem in [s for s, (p, *_) in pending.items()
                     if p.poll() is not None]:
            BUILD_SECONDS[stem] = time.perf_counter() - t0
            del pending[stem]
        time.sleep(0.05)
    for stem, (proc, tmp, lib, log_path) in procs.items():
        BUILD_LOG[stem] = log_path.read_text()
        if proc.returncode != 0:
            log_path.unlink()
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode})\n"
                          f"{BUILD_LOG[stem]}")
            continue
        os.replace(log_path, lib.with_suffix(".log"))
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds every
    source on the first call)."""
    lib = _LIBS.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise KeyError(f"no csrc/{stem}.cu; have {sorted(paths)}")
        lib = ctypes.CDLL(str(paths[stem]))
        _LIBS[stem] = lib
    return lib


_SM_COUNT: Dict[int, int] = {}
# the NVIDIA H100 SXM's SMs (data sheet): what the planners plan for on
# the meta device (the dry run prices the H100's launches)
H100_SMS = 132


def sm_count(device) -> int:
    """The SMs of a CUDA device (the launch planners' input), read once;
    ``H100_SMS`` for the meta device."""
    if device.type == "meta":
        return H100_SMS
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _SM_COUNT:
        props = torch.cuda.get_device_properties(i)
        _SM_COUNT[i] = props.multi_processor_count
    return _SM_COUNT[i]


def check(err: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
