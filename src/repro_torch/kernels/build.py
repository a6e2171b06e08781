"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source started together, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. No
PyTorch header is compiled, which keeps a cold build to seconds. The
library lands under ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, so an edited source is never served stale.

Nothing is built when this module is imported: ``load()`` builds at first
use, so the CPU tests import every kernel module without ``nvcc``. A
missing ``nvcc`` or a failed build raises; nothing falls back, in the
forward kernels or in the backward ones (``swa_bwd.cu``, ``wkv6_bwd.cu``)
that autograd reaches through the swa and wkv6 wrappers.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_STEM = "librepro_torch_kernels"
DEFAULT_CUDA_ROOTS = ("/usr/local/cuda",)

# no --use_fast_math: log1pf, sqrtf and division stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C signature of every entry point: (argtypes, restype int)
SIGNATURES = {
    "repro_probe": (_P, _P, _I, _I, _P),
    "repro_pairscore": (_P, _P, _P, _P, _P, _P, _L,
                        _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P),
    "repro_fedagg": (_P, _I, _I, _L, _P, _P, _I, _L, _I, _P),
    "repro_planner": (_P, _L, _P, _L, _P, _L, _P, _P, _P, _L, _I, _P, _I,
                      _I, _P),
    "repro_swa": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                  _F, _I, _P),
    "repro_wkv6": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _I, _I, _I, _I, _P),
    "repro_swa_bwd": (_P,) * 13 + (_I,) * 8 + (_F, _F, _I, _P),
    "repro_wkv6_bwd": (_P,) * 18 + (_I,) * 8 + (_P,),
}


class BuildInfo:
    """What the last ``load()`` did: library path, seconds spent in nvcc
    (0.0 when the library was already there) and the compiler's output
    (``-Xptxas=-v`` register and spill report)."""
    path: Path | None = None
    seconds: float = 0.0
    log: str = ""


def find_nvcc() -> str:
    """Path of ``nvcc``: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *DEFAULT_CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found ($PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this host; run on the CPU with "
        "device='cpu'")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the compiler's output if
    any fails, else return the collected output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate(timeout=900)
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(cmd)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return log


def _build(srcs: list[Path], lib_path: Path) -> str:
    nvcc = find_nvcc()
    obj_dir = lib_path.with_suffix(".objs")
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / (src.stem + ".o") for src in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(srcs, objs)])
    tmp = lib_path.with_name(lib_path.name + f".tmp{os.getpid()}")
    log += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC",
                      *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    return log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source set) and load the kernel library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib_path = BUILD_DIR / f"{LIB_STEM}_{_digest(srcs)}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        BuildInfo.log = _build(srcs, lib_path)
        BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = lib_path
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def aligned(t):
    """``t`` contiguous, or a copy of it whose data starts on a 16-byte
    boundary (a contiguous view at an odd offset of its storage), as TMA
    and cp.async need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch "
                           f"(cudaGetLastError)")


_COUNT_LOCK = threading.Lock()


def count_launch(fn) -> None:
    """Add one to the wrapper's ``launches``, under a lock: the seed split
    of ``shard=True`` launches kernels from one worker thread a card."""
    with _COUNT_LOCK:
        fn.launches += 1
