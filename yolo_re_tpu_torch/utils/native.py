"""ctypes bindings for the native host runtime (counterpart of
yolo_re_tpu/utils/native.py).

`csrc/host/yolo_host.cpp` (a copy of native/yolo_host.cpp, pinned byte for
byte by tests/test_torch_native.py) holds C++ equivalents of the host
loader's OpenCV calls: bilinear resize, letterbox, HSV augmentation and the
mosaic tile blit. The library is built at first use, never at import, with
`$CXX` (default g++) and native/Makefile's flags into
`yolo_re_tpu_torch/_build/<key>/libyolo_host.so`; the key hashes the
source, the flags, the compiler and the host CPU's feature flags
(`-march=native` makes the binary depend on them), so a copy of the tree
on another machine builds its own. A build is written under a temporary
name and renamed into place, and one lock serializes the first use across
the loader's threads.

The loader dispatches through these functions only when `enabled()`, which
reads YOLO_TPU_NATIVE, the data path's switch in both packages:
  "0" (default) -- the cv2/numpy paths,
  "1"           -- the native kernels; raises, with the compiler's output,
                   if the library does not build,
  "auto"        -- the native kernels when the library builds.
The kernels match cv2 within 1-2 uint8 LSB (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from yolo_re_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    build_into,
    run_compiler,
    source_key,
)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / \
    "yolo_host.cpp"
LIB_NAME = "libyolo_host.so"
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_lock = threading.Lock()
# (compiler, build directory) -> the loaded library, or the build's error
_libs: dict[tuple[str, str], ctypes.CDLL | RuntimeError] = {}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _cpu_flags() -> str:
    """The host CPU's feature flags, which `-march=native` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.machine()


def build() -> Path:
    """Compile the library if no build for this source, flags, compiler and
    CPU exists under BUILD_DIR; return its path. Raises RuntimeError with
    the compiler's output if it fails."""
    cxx = _compiler()

    def compile_fn(tmp_dir: Path) -> Path:
        tmp = tmp_dir / LIB_NAME
        run_compiler([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)])
        return tmp

    key = source_key([SOURCE], CXX_FLAGS, f"{cxx} {_cpu_flags()}")
    return build_into(BUILD_DIR / key, LIB_NAME, compile_fn)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    cf = ctypes.c_float
    lib.resize_bilinear_u8.argtypes = [u8p, c, c, c, u8p, c, c]
    lib.letterbox_u8.argtypes = [u8p, c, c, c, u8p, c, c, ctypes.c_uint8,
                                 c, f32p, f32p]
    lib.hsv_augment_u8.argtypes = [u8p, c, c, cf, cf, cf]
    lib.blit_u8.argtypes = [u8p, c, c, u8p, c, c, c, c, c, c, c, c]
    return lib


def _lib() -> ctypes.CDLL | RuntimeError:
    """The library (built and loaded on first call), or why it is not."""
    key = (_compiler(), str(BUILD_DIR))
    got = _libs.get(key)
    if got is None:
        with _lock:
            got = _libs.get(key)
            if got is None:
                try:
                    got = _load(build())
                except (RuntimeError, OSError) as e:
                    got = RuntimeError(f"the native host library did not "
                                       f"build or load: {e}")
                _libs[key] = got
    return got


def _required() -> ctypes.CDLL:
    lib = _lib()
    if isinstance(lib, RuntimeError):
        raise lib
    return lib


def available() -> bool:
    """Does the library build and load?"""
    return not isinstance(_lib(), RuntimeError)


def enabled() -> bool:
    """Should the host pipeline dispatch through the native kernels?
    YOLO_TPU_NATIVE: "0" (default) no; "1" yes, and the library must build
    (RuntimeError with the compiler's output otherwise); "auto" when it
    builds. With "1"/"auto" the loader trades cv2's exact bits for the
    kernels' (within 1-2 LSB)."""
    mode = os.environ.get("YOLO_TPU_NATIVE", "0")
    if mode == "0":
        return False
    if mode == "1":
        _required()
        return True
    return available()


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = _required()
    img = np.ascontiguousarray(img)
    h, w, ch = img.shape
    out = np.empty((out_h, out_w, ch), np.uint8)
    lib.resize_bilinear_u8(img, h, w, ch, out, out_h, out_w)
    return out


def letterbox(img: np.ndarray, out_h: int, out_w: int,
              pad_value: int = 114, scaleup: bool = True):
    """Native letterbox; returns (canvas, (rw, rh), (dw, dh)) matching the
    numpy implementation's contract (data/augment.py)."""
    lib = _required()
    img = np.ascontiguousarray(img)
    h, w, ch = img.shape
    out = np.empty((out_h, out_w, ch), np.uint8)
    ratio = np.zeros(2, np.float32)
    pad = np.zeros(2, np.float32)
    lib.letterbox_u8(img, h, w, ch, out, out_h, out_w, pad_value,
                     int(scaleup), ratio, pad)
    return out, (float(ratio[0]), float(ratio[1])), (float(pad[0]),
                                                     float(pad[1]))


def blit(canvas: np.ndarray, src: np.ndarray, y1a: int, x1a: int,
         y2a: int, x2a: int, y1b: int, x1b: int) -> None:
    """Copy src[y1b:y1b+(y2a-y1a), x1b:x1b+(x2a-x1a)] into
    canvas[y1a:y2a, x1a:x2a] (bounds-checked row memcpy): the mosaic tile
    composer (reference tile math: src/yolo/data/transforms.py:114-136)."""
    lib = _required()
    if not canvas.flags["C_CONTIGUOUS"] or canvas.dtype != np.uint8:
        raise ValueError("blit: the canvas must be C-contiguous uint8")
    src = np.ascontiguousarray(src)
    ch_, cw = canvas.shape[:2]
    sh, sw = src.shape[:2]
    lib.blit_u8(canvas, ch_, cw, src, sh, sw,
                y1a, x1a, y2a, x2a, y1b, x1b)


def hsv_augment(img: np.ndarray, h_mul: float, s_mul: float,
                v_mul: float) -> np.ndarray:
    """In-place HSV gain augmentation on BGR uint8."""
    lib = _required()
    if not img.flags["C_CONTIGUOUS"] or img.dtype != np.uint8:
        raise ValueError("hsv_augment: the image must be C-contiguous "
                         "uint8 (it is changed in place)")
    h, w, _ = img.shape
    lib.hsv_augment_u8(img, h, w, h_mul, s_mul, v_mul)
    return img
