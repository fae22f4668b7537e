"""Build-on-first-use for the smhtess shared library.

smhtess.cpp implements the Tesseract C API subset the ctypes binding uses
(see its header comment); this module compiles it and hands back the .so
path so `ocr/tesseract.py` can be pointed at it via SMH_TESS_LIB, and so
tests can exercise the binding end-to-end on hosts without a real
traineddata (reference counterpart: the embedded-traineddata init in
/root/reference/vision-ocr/src/lib.rs:129-159).
"""

from __future__ import annotations

import pathlib
import subprocess
import threading

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "smhtess.cpp"
_SO = _HERE / "libsmhtess.so"

_lock = threading.Lock()


def lib_path() -> pathlib.Path:
    """Compile smhtess.cpp (if the library is missing or older than the
    source) and return the library path. Raises RuntimeError when the build
    fails: a stale library from another source revision is never used."""
    with _lock:
        if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", str(_SO), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"smhtess build failed: {e}: {detail.decode(errors='replace')[-600:]}"
            ) from e
        return _SO
