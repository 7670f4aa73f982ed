"""Build and load the hand-written CUDA kernels (csrc/) at first use.

All sources compile in ONE `nvcc` call for sm_90a into a shared library
with a plain C interface, loaded through ctypes: no PyTorch headers, so the
build takes seconds. The library goes to `<package>/_build/` (listed in
.gitignore), named by a hash of the sources, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import: the build
happens when a CUDA tensor first reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "launch", "use_kernel", "check_operand", "BUILD_INFO"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (every entry returns cudaGetLastError()).
_SIGNATURES = {
    "ica_warp_planar": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ica_warp_floor": [_P, _P, _I, _I, _I, _I, _P],
    "ica_weighted_moments": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "ica_fused_iter_moments": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _F, _P],
}

# Filled by the first load: library path, whether it was compiled in this
# process, compile seconds and the compiler's resource report.
BUILD_INFO: dict = {}
_LIB = None


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on the first call if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = _BUILD_DIR / f"libica_kernels_{_digest()}.so"
    BUILD_INFO.update(path=str(lib_path), compiled=False, seconds=0.0, log="")
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        # Compile to a private name and rename into place, so concurrent
        # first users never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp, *cu],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_INFO.update(compiled=True, seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ica_error_string.argtypes = [ctypes.c_int]
    lib.ica_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def use_kernel(*tensors) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (take the plain version).
    Anything else raises: a wrapper never moves data between devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all be on CUDA or all on the CPU, got {kinds}")


def check_operand(t, name: str, shape: tuple) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape`."""
    import torch

    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def launch(name: str, *args) -> None:
    """Call C entry `name` on the current CUDA stream; raise on a launch error."""
    import torch

    lib = load_library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ica_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: cudaError {err} ({msg})")
