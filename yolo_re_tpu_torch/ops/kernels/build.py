"""Build and load the package's hand-written CUDA kernels.

All sources under ``yolo_re_tpu_torch/csrc/*.cu`` compile with ``nvcc``
(one process per source, all started together, then one link) into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds). The build happens at
first use, never at import, into ``yolo_re_tpu_torch/_build/<key>/``
(listed in ``.gitignore``); the key hashes the sources, the flags and the
compiler, so an edited kernel rebuilds and an unchanged one is reused.

There is no fallback: a missing ``nvcc`` or a failing build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libyolo_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes. Every entry returns cudaGetLastError().
SIGNATURES = {
    # x, w, b, y, B, H, W, C, dtype, stream
    "yolo_stem_conv": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, y, B, H, W, C, dtype, stream
    "yolo_stem_conv_raw": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, g, part, dw, B, H, W, C, nblk, dtype, stream
    "yolo_stem_wgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w1p, b1, w2p, b2, y, B, H, W, Cin, Cout, dtype, stream
    "yolo_adown": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w1p, w2p, y, B, H, W, Cin, Cout, dtype, stream
    "yolo_adown_raw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # w1, w2, w1p, w2p, Co, Ch, src dtype, dst dtype, stream
    "yolo_adown_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, g, w1t, w2t, dx, dw1, dw2, M, idx, dM, dA1, avg1, part,
    # B, H, W, Cin, Cout, S, dtype, stream
    "yolo_adown_bwd": (_P,) * 13 + (_I,) * 7 + (_P,),
    # boxes, scores, out_idx, B, K, max_det, iou_thres, cluster size, stream
    "yolo_nms_select": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    # m, wt, bias, out, B, H, W, n, dtype, stream
    "yolo_csp_chain": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, b, y, B, H, W, dtype, stream
    "yolo_conv3_silu": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # y, weight, bias, stats, part, part floats, tickets, tickets' length,
    # running mean, var, count of module 0 and of module 1, split, rows, C,
    # eps, momentum, 1 - momentum, n / (n - 1), update, z, act, dtype,
    # stream
    "yolo_bn_forward": (_P,) * 5 + (_L, _P, _I) + (_P,) * 6 + (_I,) * 3
    + (_F,) * 4 + (_I, _P, _I, _I, _P),
    # g, y, stats, grads, part, part floats, tickets, tickets' length, dx,
    # rows, C, g's row pitch, act, dtype, stream
    "yolo_bn_backward": (_P,) * 5 + (_L, _P, _I, _P) + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "yolo_re_tpu_torch are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_key(sources, flags, compiler: str) -> str:
    """The build directory's name: a hash of the sources (names and bytes),
    the flags and the compiler, so that a change to any of them builds
    anew and an unchanged build is reused. utils/native.py keys the host
    library the same way."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(compiler.encode())
    return h.hexdigest()[:16]


def build_key(nvcc: str) -> str:
    return source_key(_sources(), NVCC_FLAGS, nvcc)


def build_into(out_dir: Path, lib_name: str, compile_fn) -> Path:
    """out_dir/<lib_name> (out_dir: BUILD_DIR/<key>), made by
    `compile_fn(tmp_dir)` if it does not exist yet. `compile_fn` builds the
    library inside `tmp_dir`, a temporary directory beside the final
    place, and returns its path; the library is then renamed into place, so a concurrent or cut-off build
    never leaves a half-written library under the final name.
    utils/native.py builds the host library through this too."""
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        os.replace(compile_fn(Path(tmp_dir)), lib)
    return lib


def run_compiler(cmd: list[str]) -> None:
    """Run one compiler command; RuntimeError with its output if the
    compiler is missing or fails."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile the library if no build for the current sources exists;
    return its path."""
    nvcc = _nvcc()

    def compile_fn(tmp_dir: Path) -> Path:
        global last_build_seconds
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        procs = []
        objects = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = str(tmp_dir / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", obj,
                   str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objects.append(obj)
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = tmp_dir / LIB_NAME
        run_compiler([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objects])
        last_build_seconds = time.perf_counter() - t0
        return tmp

    return build_into(BUILD_DIR / build_key(nvcc), LIB_NAME, compile_fn)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.yolo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().yolo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
