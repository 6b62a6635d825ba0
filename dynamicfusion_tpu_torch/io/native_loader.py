"""ctypes binding for the repository's native dfio library
(``native/libdfio.so``: PNG decode and a prefetching loader), a copy of
``dynamicfusion_tpu.io.native_loader``. Host-side I/O: without the library
(``make -C native`` builds it) it decodes with PIL, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libdfio.so",
)

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.dfio_decode.restype = ctypes.c_int64
    lib.dfio_decode.argtypes = [ctypes.c_char_p]
    lib.dfio_image_info.restype = ctypes.c_int
    lib.dfio_image_info.argtypes = [ctypes.c_int64] + [ctypes.POINTER(ctypes.c_uint32)] * 4
    lib.dfio_image_copy.restype = ctypes.c_int
    lib.dfio_image_copy.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t]
    lib.dfio_image_free.restype = None
    lib.dfio_image_free.argtypes = [ctypes.c_int64]
    lib.dfio_loader_open.restype = ctypes.c_int64
    lib.dfio_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dfio_loader_get.restype = ctypes.c_int64
    lib.dfio_loader_get.argtypes = [ctypes.c_int64, ctypes.c_size_t]
    lib.dfio_loader_close.restype = None
    lib.dfio_loader_close.argtypes = [ctypes.c_int64]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _image_from_handle(lib, handle: int) -> np.ndarray:
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_uint32()
    bits = ctypes.c_uint32()
    if lib.dfio_image_info(handle, w, h, ch, bits) != 0:
        raise RuntimeError("dfio: bad image handle")
    dtype = np.uint16 if bits.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    out = np.empty(shape, dtype=dtype)
    rc = lib.dfio_image_copy(handle, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    lib.dfio_image_free(handle)
    if rc != 0:
        raise RuntimeError(f"dfio: copy failed rc={rc}")
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to a numpy array (uint16 for 16-bit depth images —
    the Kinect/VolumeDeform convention)."""
    lib = _load()
    if lib is not None:
        handle = lib.dfio_decode(path.encode())
        if handle:
            return _image_from_handle(lib, handle)
        raise RuntimeError(f"dfio: failed to decode {path}")
    from PIL import Image  # fallback

    img = Image.open(path)
    arr = np.array(img)
    return arr


class PrefetchingSequence:
    """Iterates decoded frames of a PNG sequence with background decoding
    (native worker pool) so decode overlaps device compute. Falls back to
    synchronous PIL decoding without the native library."""

    def __init__(self, paths, threads: int = 4, depth: int = 8):
        self.paths = list(paths)
        self._lib = _load()
        self._handle = 0
        if self._lib is not None and self.paths:
            joined = "\n".join(self.paths).encode()
            self._handle = self._lib.dfio_loader_open(joined, threads, depth)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if not (0 <= idx < len(self.paths)):
            raise IndexError(idx)
        if self._handle:
            img_h = self._lib.dfio_loader_get(self._handle, idx)
            if img_h:
                return _image_from_handle(self._lib, img_h)
            raise RuntimeError(f"dfio: failed frame {idx}: {self.paths[idx]}")
        return read_png(self.paths[idx])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._handle and self._lib is not None:
            self._lib.dfio_loader_close(self._handle)
            self._handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
