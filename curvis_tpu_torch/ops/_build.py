"""Build the CUDA kernels of ``curvis_tpu_torch/csrc`` and load them.

At the first kernel launch (never at import) each ``csrc/*.cu`` source is
compiled by its own ``nvcc`` process, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v [SOURCE_FLAGS] -c -o <object> \\
         csrc/<source>.cu

(``SOURCE_FLAGS`` adds flags for one source: the DP5(4) marches, the Kerr
RK4 march and the checkpoint kernels that replay them are built without
FMA contraction),
and the objects are linked into one shared library with a plain C
interface,
``build/curvis_tpu_torch/libcurvis_kernels.so``, which is loaded with
``ctypes``.  The library is rebuilt when the SHA-256 of the sources
and flags changes (kept beside it in a stamp file).  A failed build raises
with nvcc's output; nothing is downloaded or prebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "curvis_tpu_torch"
LIB_NAME = "libcurvis_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]    # register / spill report in build.log
LINK_FLAGS = [*ARCH, "-shared"]
# The DP5(4) marches (kernels #4 and #8), the Kerr RK4 march (#7) and the
# checkpoint kernels that replay them round every operation as their plain
# PyTorch versions do: an adaptive march's accept / reject decisions at
# err ~ 1 flip on the last bit (with contracted FMAs the Kerr kernel took
# other step sequences than its plain version on 1-2.5 % of rays, measured
# on the H100), a replay that accepts where the forward rejected marches
# another trajectory, and one step source inlined into two kernels can
# contract differently in each.  One source per step (csrc/rk45.cuh,
# rk45_surface.cuh, kerr_step.cuh) and one set of flags make each march
# and its replay take the same steps.  The RK4 march #7 takes no such
# decision; it and its replay are built so for the check against their
# plain versions: contracted, the replay still equalled #7 bit for bit,
# but the plain pair, rounding apart, went non-finite on the path's view
# (rays near the pole by the horizon amplify a last-bit difference beyond
# float32's range within one segment), so ray sums could not be compared
# (measured on the H100, PERF.md).
_NO_FMA = ["--fmad=false"]
SOURCE_FLAGS = {src: _NO_FMA for src in (
    "kerr.cu", "kerr_rk45.cu", "planar_rk45.cu", "planar_rk45_disk.cu",
    "ckpt_kerr.cu", "ckpt_kerr_rk45.cu", "ckpt_kerr_surface.cu",
    "ckpt_kerr_surface_rk45.cu", "ckpt_rk45.cu",
    "ckpt_surface_rk45.cu", "ckpt_surface_rk45_schwarzschild.cu",
    "ckpt_surface_rk45_rn.cu")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    # kind, scalars, n_scalars, table, l, psi, p_l, b, l_out, psi_out,
    # pl_out, sign_out, steps_out, n, max_steps, device, stream
    "curvis_march_planar": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, table, wx, wy, wz, sign, H, n, max_steps,
    # device, stream
    "curvis_render_fused": [_I, _P, _I, _P, _P, _P, _P, _P, _I,
                            ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, table, l, psi, p_l, b, l_out, psi_out,
    # pl_out, sign_out, steps_out, iters_out, n, max_steps, max_iters,
    # device, stream
    "curvis_march_planar_rk45": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                                 _P],
    # kind, vol, blackbody, redshift, doppler, scatter, scalars, n_scalars,
    # l, psi, p_l, b, c1, c2, nz, fout (9 | 7 x n), iout (3 x n), n,
    # max_steps, max_iters, device, stream
    "curvis_march_planar_rk45_disk": [_I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _P,
                                      ctypes.c_longlong, _I, _I, _I, _P],
    # kind, scalars, n_scalars, table, wx, wy, wz, sign, H, n, max_steps,
    # max_iters, device, stream
    "curvis_render_fused_rk45": [_I, _P, _I, _P, _P, _P, _P, _P, _I,
                                 ctypes.c_longlong, _I, _I, _I, _P],
    # kind, scalars, n_scalars, table, l, psi, p_l, b, steps, ckpt, n, seg,
    # device, stream
    "curvis_ckpt_gen": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, table, ckpt, b, steps, cot_l, cot_psi,
    # cot_pl, lam_l, lam_psi, lam_pl, g0, g1, g2, gb, gc, n, seg, device,
    # stream
    "curvis_ckpt_bwd": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # kind, vol, flags, scalars, n_scalars, l, psi, p_l, b, c1, c2, nz,
    # steps, offsets, ckpt, final, n, seg, device, stream
    "curvis_ckpt_surface_gen": [_I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                                _I, _P],
    # kind, vol, flags, scalars, n_scalars, ckpt, b, c1, c2, nz, steps,
    # offsets, cot, lam, g_theta, n, seg, device, stream
    "curvis_ckpt_surface_bwd": [_I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                                _P],
    # kind, scalars, n_scalars, table, l, psi, p_l, b, iters, offsets, ckpt,
    # final, n, seg, device, stream
    "curvis_ckpt_rk45_gen": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, table, freeze, ckpt, b, iters, offsets, cot,
    # lam, g_theta, n, seg, device, stream
    "curvis_ckpt_rk45_bwd": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.c_longlong, _I, _I, _P],
    # kind, vol, flags, scalars, n_scalars, l, psi, p_l, b, c1, c2, nz,
    # iters, offsets, ckpt, final, n, seg, device, stream
    "curvis_ckpt_surface_rk45_gen": [_I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P,
                                     ctypes.c_longlong, _I, _I, _P],
    # kind, vol, flags, scalars, n_scalars, freeze, ckpt, b, c1, c2, nz,
    # iters, offsets, cot, lam, g_theta, n, seg, device, stream
    "curvis_ckpt_surface_rk45_bwd": [_I, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P,
                                     ctypes.c_longlong, _I, _I, _P],
    # kind, scalars, n_scalars, l, psi, p_l, b, c1, c2, fout (9 x n),
    # iout (2 x n), n, max_steps, device, stream
    "curvis_march_disk": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_longlong, _I, _I, _P],
    # kind, blackbody, redshift, doppler, scatter, scalars, n_scalars, l,
    # psi, p_l, b, c1, c2, nz, fout (7 x n), iout (2 x n), n, max_steps,
    # device, stream
    "curvis_march_disk_vol": [_I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # track_disk, vol, scatter, blackbody, beaming, scalars, n_scalars, r,
    # theta, phi, p_r, p_theta, E, L, fout (5 + 6 | 4 x n), iout (2 x n),
    # n, max_steps, device, stream
    "curvis_march_kerr": [_I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # track_disk, vol, scatter, blackbody, beaming, scalars, n_scalars, r,
    # theta, phi, p_r, p_theta, E, L, fout (5 + 6 | 4 x n), iout (3 x n),
    # n, max_steps, max_iters, device, stream
    "curvis_march_kerr_rk45": [_I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                               _I, _P],
    # scalars, n_scalars, r, theta, phi, p_r, p_theta, E, L, steps (iters),
    # offsets, ckpt, final, n, seg, device, stream
    "curvis_ckpt_kerr_gen": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, ctypes.c_longlong, _I, _I, _P],
    "curvis_ckpt_kerr_rk45_gen": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, ctypes.c_longlong, _I, _I, _P],
    # scalars, n_scalars, ckpt, E, L, steps, offsets, cot, lam, g_theta, n,
    # seg, device, stream
    "curvis_ckpt_kerr_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.c_longlong, _I, _I, _P],
    # scalars, n_scalars, freeze, ckpt, E, L, iters, offsets, cot, lam,
    # g_theta, n, seg, device, stream
    "curvis_ckpt_kerr_rk45_bwd": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P, ctypes.c_longlong, _I, _I, _P],
    # vol, flags, scalars, n_scalars, r, theta, phi, p_r, p_theta, E, L,
    # steps (iters), offsets, ckpt, final, n, seg, device, stream
    "curvis_ckpt_kerr_surface_gen": [_I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, ctypes.c_longlong,
                                     _I, _I, _P],
    "curvis_ckpt_kerr_surface_rk45_gen": [_I, _I, _P, _I, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _P, _P, _P,
                                          ctypes.c_longlong, _I, _I, _P],
    # vol, flags, scalars, n_scalars, ckpt, E, L, steps, offsets, cot, lam,
    # g_theta, n, seg, device, stream
    "curvis_ckpt_kerr_surface_bwd": [_I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _P, ctypes.c_longlong, _I, _I, _P],
    # vol, flags, scalars, n_scalars, freeze, ckpt, E, L, iters, offsets,
    # cot, lam, g_theta, n, seg, device, stream
    "curvis_ckpt_kerr_surface_rk45_bwd": [_I, _I, _P, _I, _I, _P, _P, _P, _P,
                                          _P, _P, _P, _P, ctypes.c_longlong,
                                          _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
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


def nvcc_commands(nvcc: str, out: Path):
    """(one compile command per csrc/*.cu, the command linking their
    objects into the library ``out``); the objects go beside ``out``."""
    compiles, objects = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{out.name}.{src.stem}.o")
        objects.append(str(obj))
        compiles.append([nvcc, *COMPILE_FLAGS,
                         *SOURCE_FLAGS.get(src.name, []), "-c", "-o",
                         str(obj), str(src)])
    return compiles, [nvcc, *LINK_FLAGS, "-o", str(out), *objects]


def _run(cmd):
    """(source, exit code, stdout, stderr, seconds) of one nvcc command."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return (cmd[-1], proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def build() -> Path:
    """Compile the library unless an up-to-date one exists; its path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libcurvis_kernels.sha256"
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(find_nvcc(), tmp)
    try:
        with ThreadPoolExecutor(len(compiles)) as pool:
            runs = list(pool.map(_run, compiles))
        if all(rc == 0 for _, rc, _, _, _ in runs):
            runs.append(("link", *_run(link)[1:]))
        (BUILD_DIR / "build.log").write_text("".join(
            f"== {src} ({secs:.1f} s)\n{out}{err}"
            for src, _, out, err, secs in runs))
        failed = [(src, rc, err) for src, rc, _, err, _ in runs if rc != 0]
        if failed:
            src, rc, err = failed[0]
            raise RuntimeError(f"nvcc failed on {src} with exit code {rc}:"
                               f"\n{err}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for c in compiles:
            Path(c[c.index("-o") + 1]).unlink(missing_ok=True)
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


def table_ptr(tab):
    """The address of a ``ChebTable`` argument (kept alive by the caller
    across the launch), or None (a null pointer) for an analytic kind."""
    return None if tab is None else ctypes.addressof(tab)


def host_floats(values):
    """A ctypes float array of ``values`` (kept alive by the caller across
    the launch; the launcher copies it into the kernel argument)."""
    return (ctypes.c_float * len(values))(*values)
