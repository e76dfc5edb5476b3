"""ctypes bindings to the native fast-IO and XTC codec libraries.

Each library is compiled at first use from its committed source
(spinrelax_tpu/native/<name>.cpp, plain C ABI, no pybind11) into
spinrelax_tpu/native/build/lib<name>-<key>.so, where <key> hashes the
source bytes and the compiler command.  Only the library whose key
matches the source in the tree is ever loaded, so a stale or foreign
build cannot be picked up.  When no compiler is available the loaders
return None and callers degrade to the numpy text parsers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
CXX_COMMAND = ("g++", "-O3", "-pthread", "-shared", "-fPIC")
_BUILT: dict = {}  # library name -> {"path", "built_now"} this process


def _build_lib(src: str, out: str):
    """Compile ``src`` to ``out``.  The compile targets a pid-suffixed
    temp path + atomic os.replace: two concurrent processes (parallel CLI
    runs, pytest workers) may both build, and one must never dlopen the
    other's half-written output."""
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [*CXX_COMMAND, src, "-o", tmp], check=True, capture_output=True,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library_path(name: str) -> str:
    """Keyed build path of native/<name>.cpp (see module docstring)."""
    with open(os.path.join(_NATIVE_DIR, name + ".cpp"), "rb") as fp:
        h = hashlib.sha256(" ".join(CXX_COMMAND).encode() + b"\0" + fp.read())
    return os.path.join(_BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def ensure_built(name: str) -> str:
    """Path of the library built from the committed native/<name>.cpp,
    compiling it first if this source has no build yet."""
    out = library_path(name)
    built_now = not os.path.exists(out)
    if built_now:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        _build_lib(os.path.join(_NATIVE_DIR, name + ".cpp"), out)
    _BUILT[name] = {"path": os.path.relpath(out, _NATIVE_DIR),
                    "built_now": built_now}
    return out


def library_report() -> dict:
    """Which native libraries this process loaded, and whether it had
    to compile them."""
    return {name: dict(info, loaded=(name == "fastio" and _lib is not None)
                       or (name == "xtc" and _xtc_lib is not None))
            for name, info in _BUILT.items()}


_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(ensure_built("fastio"))
        lib.fastio_table_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.fastio_table_dims.restype = ctypes.c_int
        lib.fastio_parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ]
        lib.fastio_parse_table.restype = ctypes.c_long
        lib.fastio_count_fields_headers.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)
        ]
        lib.fastio_count_fields_headers.restype = ctypes.c_int
        lib.fastio_write_table.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ]
        lib.fastio_write_table.restype = ctypes.c_int
        lib.fastio_format_sxy.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.fastio_format_sxy.restype = ctypes.c_longlong
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def load_table(fn: str, skip_chars: str = "#@&") -> Optional[np.ndarray]:
    """Parse a numeric text table -> (nRows, nCols) float64, or None when
    the native library is unavailable (caller falls back to numpy).
    .gz paths return None too: the mmap parser reads raw bytes, and the
    Python fallbacks gunzip transparently (io.zopen)."""
    lib = _load()
    if lib is None or str(fn).endswith(".gz"):
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.fastio_table_dims(
        fn.encode(), skip_chars.encode(), ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc != 0:
        raise OSError(f"fastio_table_dims failed on {fn!r} (code {rc})")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    n = lib.fastio_parse_table(
        fn.encode(), skip_chars.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.value, cols.value,
    )
    if n < 0:
        raise OSError(f"fastio_parse_table failed on {fn!r} (code {n})")
    if n != rows.value * cols.value:
        raise OSError(f"fastio_parse_table short read on {fn!r}")
    return out


def format_sxy(x, y) -> Optional[bytes]:
    """Render ``n`` lines ``str(np.float64(x[i])) + " " + str(np.asarray
    (y[i])).strip('[]')`` — the exact per-row bytes io.xvg.print_sxylist
    produces — in one native call.  Returns None when the native library
    is unavailable or the inputs are outside the fast path's contract
    (caller falls back to the Python loop):

    - x must be float64 (np.float64 scalar str == Python float repr);
    - y must be a contiguous (n, k) float32/float64 block with k <= 3:
      wider rows can exceed numpy's 75-char linewidth, which wraps
      str(row) across lines — the native renderer does not reproduce
      wrapping (3 elements are at most ~58 chars; 4 can reach 77).
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    y = np.asarray(y)
    if (x.dtype != np.float64 or y.ndim != 2 or y.dtype not in
            (np.float32, np.float64) or y.shape[1] > 3 or
            y.shape[0] != x.shape[0]):
        return None
    y = np.ascontiguousarray(y)
    n, k = y.shape
    cap = 64 + n * (40 + 40 * k)
    out = ctypes.create_string_buffer(cap)
    nb = lib.fastio_format_sxy(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.c_void_p),
        1 if y.dtype == np.float32 else 0,
        n, k, out, cap,
    )
    if nb < 0:
        return None
    return out.raw[:nb]


def write_table(fn: str, data, append: bool = False) -> bool:
    """Bulk-write a 2D array as "%16g"-joined rows (the PLUMED colvar
    row format).  Returns True when the native writer handled it; the
    caller should fall back to np.savetxt on False.  .gz paths return
    False: the C writer emits raw bytes, which would silently produce a
    plain-text file under a .gz name."""
    lib = _load()
    if lib is None or str(fn).endswith(".gz"):
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"write_table needs a 2D array, got {arr.shape}")
    rc = lib.fastio_write_table(
        fn.encode(), 1 if append else 0,
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1],
    )
    return rc == 0


def count_fields_headers(fn: str) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_long()
    rc = lib.fastio_count_fields_headers(fn.encode(), ctypes.byref(n))
    if rc != 0:
        raise OSError(f"fastio_count_fields_headers failed on {fn!r}")
    return n.value


# ---------------------------------------------------------------------------
# XTC codec bindings (spinrelax_tpu/native/xtc.cpp)
# ---------------------------------------------------------------------------

_xtc_lib = None
_xtc_tried = False


def _load_xtc():
    global _xtc_lib, _xtc_tried
    if _xtc_tried:
        return _xtc_lib
    _xtc_tried = True
    try:
        lib = ctypes.CDLL(ensure_built("xtc"))
        lib.xtc_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)
        ]
        lib.xtc_info.restype = ctypes.c_int
        lib.xtc_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ]
        lib.xtc_read.restype = ctypes.c_long
        lib.xtc_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_float,
        ]
        lib.xtc_write.restype = ctypes.c_int
        lib.xtc_append.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_float, ctypes.c_long,
        ]
        lib.xtc_append.restype = ctypes.c_int
        lib.xtc_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.xtc_open.restype = ctypes.c_void_p
        lib.xtc_next_mt.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ]
        lib.xtc_next_mt.restype = ctypes.c_long
        lib.xtc_close.argtypes = [ctypes.c_void_p]
        lib.xtc_close.restype = None
        lib.xtc_next_obs.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_int,
        ]
        lib.xtc_next_obs.restype = ctypes.c_long
        lib.xtc_reduce_obs.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        lib.xtc_reduce_obs.restype = None
        _xtc_lib = lib
    except Exception:
        _xtc_lib = None
    return _xtc_lib


def xtc_available() -> bool:
    return _load_xtc() is not None


def info_xtc(fn: str) -> tuple:
    """Header-scan inspection (payloads fseek'd past, no decode) ->
    (n frames, natoms)."""
    lib = _load_xtc()
    if lib is None:
        raise OSError("native XTC codec unavailable (no compiler?)")
    n_frames = ctypes.c_long()
    natoms = ctypes.c_int()
    rc = lib.xtc_info(fn.encode(), ctypes.byref(n_frames), ctypes.byref(natoms))
    if rc != 0:
        raise OSError(f"xtc_info failed on {fn!r} (code {rc})")
    return n_frames.value, natoms.value


def read_xtc(fn: str, threads: int = 1):
    """-> (xyz (nFrames, nAtoms, 3) [nm] float32, boxes (nFrames, 3, 3),
    times (nFrames,)).

    ``threads``: decode with this many worker threads (0 = one per
    core, 1 = sequential).  Output is identical regardless."""
    lib = _load_xtc()
    if lib is None:
        raise OSError("native XTC codec unavailable (no compiler?)")
    n_frames = ctypes.c_long()
    natoms = ctypes.c_int()
    rc = lib.xtc_info(fn.encode(), ctypes.byref(n_frames), ctypes.byref(natoms))
    if rc != 0:
        raise OSError(f"xtc_info failed on {fn!r} (code {rc})")
    nf, na = n_frames.value, natoms.value
    xyz = np.empty((nf, na, 3), dtype=np.float32)
    times = np.empty(nf, dtype=np.float32)
    boxes = np.empty((nf, 3, 3), dtype=np.float32)
    if nf == 0:
        # xtc_open peeks the first frame header, so it cannot open an
        # empty (e.g. aborted-writer) file — return the empty arrays the
        # sequential reader always produced.
        return xyz, boxes, times
    handle = lib.xtc_open(fn.encode(), ctypes.byref(natoms))
    if not handle:
        raise OSError(f"xtc_open failed on {fn!r}")
    try:
        got = _xtc_next_call(
            lib, handle, xyz, times, boxes, nf, _xtc_threads(lib, threads)
        )
    finally:
        lib.xtc_close(handle)
    if got != nf:
        raise OSError(f"xtc_read returned {got} of {nf} frames for {fn!r}")
    return xyz, boxes, times


def _xtc_threads(lib, threads: int) -> int:
    """0 = auto (all cores); 1 = sequential; N = exactly N workers."""
    if threads == 0:
        return os.cpu_count() or 1
    return max(1, threads)


def _xtc_next_call(lib, handle, xyz, times, boxes, max_frames, n_threads):
    """One chunk read through xtc_next_mt."""
    return lib.xtc_next_mt(
        handle,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_frames, n_threads,
    )


def iter_xtc(fn: str, chunk_frames: int, threads: int = 1):
    """Stream an .xtc in fixed-size frame chunks without loading the file
    (the >RAM ingest path; run-all.bash:359 feeds multi-GB solute.xtc).

    Yields (xyz (c, nAtoms, 3) [nm] f32, boxes (c, 3, 3), times (c,)).

    ``threads``: decode each chunk with this many worker threads (frames
    decode independently after a cheap offset scan); 0 = one per core,
    1 (default) = sequential.  Output is identical regardless.
    """
    lib = _load_xtc()
    if lib is None:
        raise OSError("native XTC codec unavailable (no compiler?)")
    n_threads = _xtc_threads(lib, threads)
    natoms = ctypes.c_int()
    handle = lib.xtc_open(fn.encode(), ctypes.byref(natoms))
    if not handle:
        raise OSError(f"xtc_open failed on {fn!r}")
    na = natoms.value
    try:
        while True:
            xyz = np.empty((chunk_frames, na, 3), dtype=np.float32)
            times = np.empty(chunk_frames, dtype=np.float32)
            boxes = np.empty((chunk_frames, 3, 3), dtype=np.float32)
            got = _xtc_next_call(
                lib, handle, xyz, times, boxes, chunk_frames, n_threads
            )
            if got < 0:
                why = {-3: "frame natoms mismatch",
                       -4: "corrupt/truncated frame mid-file"}.get(
                    got, f"code {got}")
                raise OSError(f"xtc_next failed on {fn!r}: {why}")
            if got == 0:
                return
            yield xyz[:got], boxes[:got], times[:got]
            if got < chunk_frames:
                return
    finally:
        lib.xtc_close(handle)


def write_xtc(fn: str, xyz, times=None, boxes=None, precision: float = 1000.0,
              append: bool = False, step0: int = 0):
    """Write (or, with ``append=True``, extend) an .xtc file.  XTC frames
    are self-delimiting, so appending produces a valid trajectory — the
    streaming-writer path for >RAM conversions (``step0`` numbers the
    appended frames and is the default time stamp when ``times`` is
    omitted)."""
    lib = _load_xtc()
    if lib is None:
        raise OSError("native XTC codec unavailable (no compiler?)")
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    nf, na, _ = xyz.shape
    if times is None:
        times = np.arange(step0, step0 + nf, dtype=np.float32)
    times = np.ascontiguousarray(times, dtype=np.float32)
    boxes_ptr = None
    if boxes is not None:
        boxes = np.ascontiguousarray(boxes, dtype=np.float32)
        boxes_ptr = boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if append:
        rc = lib.xtc_append(
            fn.encode(),
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            boxes_ptr, nf, na, precision, step0,
        )
    else:
        rc = lib.xtc_write(
            fn.encode(),
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            boxes_ptr, nf, na, precision,
        )
    if rc != 0:
        raise OSError(f"xtc_write failed on {fn!r} (code {rc})")


def xtc_obs_available() -> bool:
    """True when the codec with the fused decode->bond-observable reader
    (xtc_next_obs) is available."""
    return _load_xtc() is not None


def iter_xtc_obs(fn: str, chunk_frames: int, idx_h, idx_x, A,
                 threads: int = 1, out_dtype=np.float32):
    """Stream an .xtc reduced to bond observables — the fused ingest of
    stage_ct_streamed (ops/orient.bond_obs_host computed IN the decoder;
    the full (frames, natoms, 3) coordinate block never materialises).

    idx_h, idx_x : (nBonds,) atom indices of each bond's H and X ends.
    A            : (3, natoms) f64 weighted-centred reference correlation
                   matrix (ops/orient.bond_obs_matrix).
    threads      : worker threads per chunk (0 = one per core); output
                   is bit-identical for any value.

    Yields (raw_diff (c, nBonds, 3) out_dtype, S (c, 3, 3) out_dtype,
    times (c,)) — exactly bond_obs_host's contract on an f32 chunk (S is
    accumulated in f64 and cast, like the host slab reduction).
    """
    lib = _load_xtc()
    if lib is None:
        raise OSError("native fused XTC ingest unavailable")
    n_threads = _xtc_threads(lib, threads)
    natoms = ctypes.c_int()
    handle = lib.xtc_open(fn.encode(), ctypes.byref(natoms))
    if not handle:
        raise OSError(f"xtc_open failed on {fn!r}")
    na = natoms.value
    idx_h = np.ascontiguousarray(idx_h, dtype=np.int64)
    idx_x = np.ascontiguousarray(idx_x, dtype=np.int64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    if A.shape != (3, na):
        lib.xtc_close(handle)
        raise ValueError(f"A shape {A.shape} != (3, {na})")
    if idx_h.size and (
        max(idx_h.max(), idx_x.max()) >= na
        or min(idx_h.min(), idx_x.min()) < 0
    ):
        lib.xtc_close(handle)
        raise ValueError("bond indices out of range for this trajectory")
    nb = idx_h.size
    try:
        while True:
            raw = np.empty((chunk_frames, nb, 3), dtype=np.float32)
            S = np.empty((chunk_frames, 3, 3), dtype=np.float64)
            times = np.empty(chunk_frames, dtype=np.float32)
            got = lib.xtc_next_obs(
                handle,
                idx_h.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                idx_x.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                nb,
                A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                raw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                S.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                chunk_frames, n_threads,
            )
            if got < 0:
                why = {-3: "frame natoms mismatch",
                       -4: "mid-file decode failure / truncation"}
                raise OSError(
                    f"xtc_next_obs failed on {fn!r}: "
                    f"{why.get(got, f'code {got}')}"
                )
            if got == 0:
                break
            yield (
                raw[:got].astype(out_dtype, copy=False),
                S[:got].astype(out_dtype, copy=False),
                times[:got],
            )
            if got < chunk_frames:
                break
    finally:
        lib.xtc_close(handle)


def reduce_obs_mem(xyz, idx_h, idx_x, A, threads: int = 1):
    """Native in-memory bond-observable reduction over a decoded f32
    chunk — the same per-frame loop as the fused .xtc reader, so both
    produce bit-identical observables (ops/orient.bond_obs_host routes
    its f32 fast path here).  Returns (raw_diff f32, S f64) or None when
    the native codec (or the obs entry point) is unavailable or the
    input is not an f32 (F, natoms, 3) block."""
    lib = _load_xtc()
    if lib is None:
        return None
    xyz = np.asarray(xyz)
    if xyz.dtype != np.float32 or xyz.ndim != 3 or xyz.shape[2] != 3:
        return None
    xyz = np.ascontiguousarray(xyz)
    nf, na, _ = xyz.shape
    idx_h = np.ascontiguousarray(idx_h, dtype=np.int64)
    idx_x = np.ascontiguousarray(idx_x, dtype=np.int64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    if A.shape != (3, na):
        raise ValueError(f"A shape {A.shape} != (3, {na})")
    nb = idx_h.size
    raw = np.empty((nf, nb, 3), dtype=np.float32)
    S = np.empty((nf, 3, 3), dtype=np.float64)
    lib.xtc_reduce_obs(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nf, na,
        idx_h.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        idx_x.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), nb,
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _xtc_threads(lib, threads),
    )
    return raw, S
