"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Every ``.cu`` file under ``csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, all files in parallel, at first
use, into ``build/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``; git ignores it).  A library's file name carries
a hash of its sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  Libraries are loaded with ``ctypes``; the kernel
modules declare their entry points' argument types, with
``ctypes.c_void_p`` for every pointer and the stream.  Every C entry
returns ``cudaGetLastError()`` right after its launch and
:func:`check` raises when it is not 0 — a launch the card refuses (too
many threads, too much shared memory) never runs and no later
synchronisation would report it.

Building needs ``nvcc`` (``/usr/local/cuda/bin`` is searched after
``PATH``).  There is no fallback: a kernel that does not build raises.

The launch counters live here too: each kernel wrapper calls
:func:`count_launch` where it launches its kernel, and nowhere else.  A
CUDA graph replay passes no wrapper, so a captured region is wrapped in
:func:`capturing`, which takes back the counts its capture made (nothing
ran) and hands them out as the capture's delta; each replay then adds
that delta (:func:`add_launches`), and the counters keep meaning kernel
launches executed.

Capture safety: every C entry launches only on the stream it is given
(:func:`stream_ptr`, PyTorch's current stream, which is the capture
stream inside ``torch.cuda.graph``) and makes no ``cudaMalloc``, no
synchronous copy and no default-stream work; its scratch comes from the
wrapper's ``torch.empty``.  The one-time ``cudaFuncSetAttribute`` calls
behind a ``static bool sized`` run at a kernel's first launch, which an
eager warm-up makes before any capture.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = ["CSRC", "build_dir", "build_all", "load", "entry", "check",
           "stream_ptr",
           "count_launch", "launch_counts", "reset_launch_counts",
           "capturing", "add_launches",
           "KERNEL_NAMES", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
# The launch counters, one per kernel: B1–B7 and B8 stage 1
# count each engine apart (``mte_gemm`` / ``splitk_gemm`` /
# ``grouped_gemm`` / ``rigid_gemm`` the tile loop, ``mte_gemm_wgmma`` /
# ``grouped_gemm_wgmma`` / ``rigid_gemm_wgmma`` the wgmma mainloop,
# ``mte_gemm_wgmma_s8`` / ``grouped_gemm_wgmma_s8`` /
# ``rigid_gemm_wgmma_s8`` its int8 entries,
# ``mte_gemm_simt`` / ``splitk_gemm_simt`` / ``grouped_gemm_simt`` /
# ``rigid_gemm_simt`` the SIMT f32 mainloop, ``splitk_gemm_cluster`` and
# ``grouped_gemm_splitk`` B2's and B3's cluster split-K kernels
# (``splitk_gemm_cluster_s8`` / ``grouped_gemm_splitk_s8`` their int8
# entries),
# ``flash_decode_paged`` / ``flash_decode_paged_mma`` B4's SIMT and mma
# kernels, ``flash_attention`` / ``flash_attention_wgmma`` B5's SIMT and
# wgmma kernels, ``flash_decode`` / ``flash_decode_mma`` B6's SIMT and mma
# kernels, ``rglru_scan`` / ``rglru_scan_staged`` B7's direct and staged
# engines), and ``rigid_gemm.cu`` holds the separate epilogue pass too.
KERNEL_NAMES = ("mte_gemm", "mte_gemm_wgmma", "mte_gemm_wgmma_s8",
                "mte_gemm_simt",
                "splitk_gemm", "splitk_gemm_cluster",
                "splitk_gemm_cluster_s8", "splitk_gemm_simt",
                "grouped_gemm", "grouped_gemm_splitk",
                "grouped_gemm_splitk_s8", "grouped_gemm_wgmma",
                "grouped_gemm_wgmma_s8", "grouped_gemm_simt",
                "flash_decode_paged", "flash_decode_paged_mma",
                "flash_attention", "flash_attention_wgmma", "rigid_gemm",
                "rigid_gemm_wgmma", "rigid_gemm_wgmma_s8",
                "rigid_gemm_simt", "epilogue_pass",
                "flash_decode",
                "flash_decode_mma", "rglru_scan", "rglru_scan_staged")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_PATHS: Dict[str, Path] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
BUILD_LOG: List[str] = []


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("repro_torch: nvcc not found (PATH, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _digest(src: Path, flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return h.hexdigest()[:12]


def build_all(*, ptxas_verbose: bool = False) -> Dict[str, float]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns seconds per
    library built (0.0 for one reused).  Raises with the compiler's
    output when a build fails."""
    with _LOCK:
        return _build_all_locked(ptxas_verbose)


def _build_all_locked(ptxas_verbose: bool) -> Dict[str, float]:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
    procs = {}
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        lib = out_dir / f"lib{name}_{_digest(src, NVCC_FLAGS)}.so"
        _PATHS[name] = lib
        if lib.exists():
            times[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG.append(f"== nvcc {name} (rc={proc.returncode}) ==\n{log}")
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("repro_torch: CUDA kernel build failed:\n"
                           + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if
    needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if name not in _PATHS or not _PATHS[name].exists():
        build_all()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_PATHS[name]))
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


_ENTRIES: Dict[tuple, object] = {}


def entry(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of library ``name`` with its argument types
    declared (once) and an int return: ``(lib, fn)``."""
    key = (name, symbol)
    got = _ENTRIES.get(key)
    if got is None:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        got = _ENTRIES[key] = (lib, fn)
    return got


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t`` (or one of
    ``wgmma_mainloop.cuh``'s tensor-map codes: 1000 + the ``CUresult`` of
    a failed ``cuTensorMapEncodeTiled``, 2000 for its missing entry
    point)."""
    if err == 0:
        return
    if err >= 2000:
        msg = "cuTensorMapEncodeTiled: no driver entry point"
    elif err >= 1000:
        msg = f"cuTensorMapEncodeTiled failed (CUresult {err - 1000})"
    else:
        msg = lib.repro_cuda_error_string(int(err)).decode()
    raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the integer the C
    entries take."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit, the
    launches the captured region made (its delta, non-zero counters
    only), and leaves the counters as they were before it — a capture
    runs no kernel."""
    before = dict(_LAUNCHES)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for name, count in before.items():
            if _LAUNCHES[name] != count:
                delta[name] = _LAUNCHES[name] - count
            _LAUNCHES[name] = count


def add_launches(delta: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured region."""
    for name, count in delta.items():
        _LAUNCHES[name] += count


def require_cuda(*tensors, what: str) -> Optional[object]:
    """The common device of ``tensors`` when it is CUDA, None when every
    tensor lies on the CPU (the plain version's case); raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev
