"""Build the CUDA kernels of ``curvis_tpu_torch/csrc`` and load them.

At the first kernel launch (never at import) the ``csrc/*.cu`` sources are
compiled by ``nvcc`` into one shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/curvis_tpu_torch/libcurvis_kernels.so \\
         curvis_tpu_torch/csrc/*.cu

which is loaded with ``ctypes``.  The library is rebuilt when the SHA-256
of the sources and flags changes (kept beside it in a stamp file).  A failed
build raises with nvcc's output; nothing is downloaded or prebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "curvis_tpu_torch"
LIB_NAME = "libcurvis_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]       # register / spill report in build.log

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    # kind, scalars, n_scalars, l, psi, p_l, b, l_out, psi_out, pl_out,
    # sign_out, steps_out, n, max_steps, device, stream
    "curvis_march_planar": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, wx, wy, wz, sign, H, n, max_steps, device,
    # stream
    "curvis_render_fused": [_I, _P, _I, _P, _P, _P, _P, _I,
                            ctypes.c_longlong, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out),
            *(str(p) for p in sorted(CSRC.glob("*.cu")))]


def build() -> Path:
    """Compile the library unless an up-to-date one exists; its path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libcurvis_kernels.sha256"
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(find_nvcc(), tmp),
                          capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.curvis_error_string.argtypes = [_I]
            lib.curvis_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def is_loaded() -> bool:
    return _lib is not None


def check(lib, err: int, what: str):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.curvis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def host_floats(values):
    """A ctypes float array of ``values`` (kept alive by the caller across
    the launch; the launcher copies it into the kernel argument)."""
    return (ctypes.c_float * len(values))(*values)
