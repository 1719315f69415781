"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. The library
lands in ``build/repro_torch/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edit to
any source rebuilds it and an unchanged tree reuses it.

Nothing here runs at import time: the first kernel launch calls
:func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argument types (pointers and the stream as
# c_void_p, ints as c_int, floats as c_float). Each returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    "dcn_fused_batch_launch": [_P] * 11 + [_I] * 12 + [_P],
    "dcn_fused_schedule_launch": [_P] * 10 + [_I] * 11 + [_P],
    "dcn_fused_tile_launch": [_P] * 8 + [_I] * 9 + [_P],
    "dcn_fused_bf16_max_clusters": [_I, _P],
    "bli_gather_launch": [_P] * 4 + [_I] * 9 + [_P],
    "schedule_group_launch": [_P, _P],
    "schedule_group_smem_bytes": [_I] * 4,
    "schedule_group_scratch_words": [_I] * 3,
    "schedule_args_size": [],
    "empty_launch": [_P],
    "flash_attention_launch": [_P] * 4 + [_I] * 9 + [_F, _F, _P],
    "flash_attention_16_launch": [_P] * 4 + [_I] * 9 + [_F, _F, _I, _P],
    "flash_decode_launch": [_P] * 7 + [_I] * 11 + [_F, _F, _P],
    "flash_decode_bf16_launch": [_P] * 5 + [_I] * 9 + [_F, _F, _P],
    "attention_any_launch": [_P] * 7 + [_I] * 21 + [_F, _F, _P],
    "attention_any_smem_bytes": [_I] * 8,
    "attention_wide_launch": [_P] * 5 + [_I] * 12 + [_F, _F, _P],
}

class KernelError(RuntimeError):
    """A kernel that did not build, load or launch. Not a fault of one
    request: the serving engine never isolates it, it re-raises."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    global build_log
    build_log = "\n".join(logs)
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n{build_log}")
    lib = out_dir / "librepro_torch_kernels.so"
    tmp = out_dir / f".{lib.name}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs], "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        if not sources:
            raise KernelError(f"no CUDA sources under {_CSRC}")
        out_dir = _BUILD_ROOT / _digest(sources)
        lib_path = out_dir / "librepro_torch_kernels.so"
        if not lib_path.exists():
            lib_path = _compile(_nvcc(), sources, out_dir)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise :class:`KernelError` if a C entry point reported a CUDA
    error."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")
