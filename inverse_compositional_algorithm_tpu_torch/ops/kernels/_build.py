"""Build and load the hand-written CUDA kernels (csrc/) at first use.

Each .cu source compiles in its own `nvcc` process for sm_90a, all started
together, and one more call links the objects into a shared library with a
plain C interface, loaded through ctypes: no PyTorch headers, so the build
takes seconds. The library goes to `<package>/_build/` (listed in
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
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (every entry returns cudaGetLastError()).
_SIGNATURES = {
    "ica_warp_planar": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ica_warp_floor": [_P, _P, _I, _I, _I, _I, _I, _P],
    "ica_weighted_moments": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "ica_fused_iter_moments": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _F, _P],
    "ica_fused_iter_ablate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "ica_trip_update": [_P] * 15 + [_I] * 9 + [_F] * 7 + [_P],
    "ica_level_pack": [_P] * 5 + [_I] * 7 + [_P],
}

# Filled by the first load: library path, whether it was compiled in this
# process, compile seconds and the compiler's resource report (kept beside
# the library, so a reused library still has it).
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
    log_path = lib_path.with_suffix(".log")
    BUILD_INFO.update(path=str(lib_path), compiled=False, seconds=0.0,
                      log=log_path.read_text() if log_path.exists() else "")
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile in a private directory and rename the library into place,
        # so concurrent first users never load a half-written one.
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            nvcc = _nvcc()
            procs = [subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-I", str(_CSRC), "-c", str(cu), "-o", f"{tmp}/{cu.stem}.o"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for cu in _sources() if cu.suffix == ".cu"]
            outs = [(proc, proc.communicate()[0]) for proc in procs]
            log = "".join(out for _, out in outs)
            if any(proc.returncode != 0 for proc, _ in outs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            link = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-shared", "-o", f"{tmp}/lib.so", *sorted(
                    str(o) for o in Path(tmp).glob("*.o"))],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}\n{link.stderr}")
            Path(f"{tmp}/lib.log").write_text(log)
            os.replace(f"{tmp}/lib.log", log_path)
            os.replace(f"{tmp}/lib.so", lib_path)
        BUILD_INFO.update(compiled=True, seconds=time.perf_counter() - t0, log=log)
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


def check_operand(t, name: str, shape: tuple, dtype=None) -> None:
    """Raise unless `t` is a contiguous tensor of `shape` and `dtype`
    (default float32)."""
    import torch

    dtype = dtype or torch.float32
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def launch(name: str, *args) -> None:
    """Call C entry `name` on the operands' device and its current stream;
    raise on a launch error.

    Tensor arguments are passed as their data pointers, and the first one
    names the device: the call runs under `torch.cuda.device` of it, so a
    kernel whose operands lie on cuda:1 launches there even while cuda:0 is
    the current device (the C entries launch on the current device).
    Operands on more than one device raise."""
    import torch

    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"{name}: kernel operands must all lie on one device, got {devs}")
    (dev,) = devs
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    lib = load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ica_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: cudaError {err} ({msg})")
