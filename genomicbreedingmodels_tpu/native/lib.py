"""Build + load the native gbmio shared library (ctypes).

The library is compiled on first use with the system g++ (C++17, -O3,
-pthread) and cached next to the sources (not tracked by git); any failure degrades gracefully to
the numpy fallbacks in io.py. No pybind11: the ABI is plain C, bound with
ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).parent / "src" / "gbmio.cpp"
_LIB = Path(__file__).parent / "src" / "libgbmio.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # Build under a per-process name and rename into place, so processes
    # that build concurrently (test workers) never load a half-written file.
    tmp = _LIB.with_name(f".{_LIB.stem}.{os.getpid()}.so")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_native() -> Optional[ctypes.CDLL]:
    """Return the loaded library, building it if necessary; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        c_long, c_int, c_char_p = ctypes.c_long, ctypes.c_int, ctypes.c_char_p
        dp = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lp = ctypes.POINTER(c_long)
        lib.gbmio_tsv_dims.argtypes = [c_char_p, lp, lp]
        lib.gbmio_tsv_dims.restype = c_int
        lib.gbmio_tsv_parse.argtypes = [c_char_p, c_long, c_long, dp, c_long, c_long, c_int, lp]
        lib.gbmio_tsv_parse.restype = c_int
        lib.gbmio_bed_decode.argtypes = [u8p, c_long, c_long, dp, c_int]
        lib.gbmio_bed_decode.restype = c_int
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.gbmio_bed_decode_i8.argtypes = [u8p, c_long, c_long, i8p, c_int, lp, c_int]
        lib.gbmio_bed_decode_i8.restype = c_int
        lib.gbmio_bed_encode.argtypes = [dp, c_long, c_long, u8p, c_int]
        lib.gbmio_bed_encode.restype = c_int
        lib.gbmio_col_means.argtypes = [dp, c_long, c_long, dp, c_int]
        lib.gbmio_col_means.restype = c_int
        lib.gbmio_quantize_grid.argtypes = [
            dp, c_long, ctypes.c_double, ctypes.c_double, u8p, c_int,
        ]
        lib.gbmio_quantize_grid.restype = c_int
        lib.gbmio_vcf_dims.argtypes = [c_char_p, lp, lp, lp]
        lib.gbmio_vcf_dims.restype = c_int
        lib.gbmio_vcf_parse.argtypes = [c_char_p, dp, c_long, c_long, c_int, lp]
        lib.gbmio_vcf_parse.restype = c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None
