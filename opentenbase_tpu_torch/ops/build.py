"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles to an object with its own `nvcc`, all started
together; the objects link into one shared library with a plain C
interface, loaded with ctypes.  The library's name carries a hash of the
sources and flags, so an unchanged tree reuses its build and an edited
one rebuilds.  Nothing here runs at import time: the CPU tests import
every module, and this machine may have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
#: C entry points: name -> argtypes (every one but those in RESTYPES
#: returns cudaGetLastError() as an int)
SIGNATURES = {
    "otbt_visibility_mask": [_P, _P, _P, _P, _LL, _LL, _LL, _P, _LL, _P],
    "otbt_visibility_mask_dev": [_P, _P, _P, _P, _P, _P, _LL, _P, _LL, _P],
    "otbt_decode_column": [_P, _I, _P, _I, _I, _LL, _P, _LL, _P],
    "otbt_cmp_on_codes": [_P, _I, _P, _I, _I, _LL, _I, _LL, _P, _LL, _P],
    "otbt_grouped_agg_dense_scratch_bytes": [_LL, _I, _I],
    "otbt_grouped_agg_dense_branch": [_LL, _I, _I],
    "otbt_grouped_agg_dense": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _P,
                               _LL, _P],
    "otbt_sort_scratch_bytes": [_I, _LL],
    "otbt_sort_perm": [_P, _I, _LL, _P, _LL, _P, _P, _P],
    "otbt_group_scratch_bytes": [_LL, _I, _I],
    "otbt_group_words": [_P, _P, _I, _LL, _P, _I, _P, _LL, _P, _P],
    "otbt_group_reduce": [_P, _P, _P, _I, _LL, _P, _P, _LL, _I, _P, _P, _P,
                          _P, _P, _P, _P, _LL, _P],
    "otbt_join_scratch_bytes": [_LL],
    "otbt_join_build": [_P, _P, _LL, _P, _LL, _P, _P, _P],
    "otbt_probe_table_bytes": [_LL, _I],
    "otbt_join_probe_counts": [_P, _LL, _P, _P, _LL, _LL, _P, _LL, _I, _P,
                               _P],
    "otbt_join_expand_scratch_bytes": [_LL],
    "otbt_join_expand": [_P, _P, _P, _P, _LL, _LL, _I, _P, _P, _LL, _P, _P,
                         _LL, _P],
    "otbt_compose_indices": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _LL, _P],
    "otbt_join_mask": [_P, _P, _LL, _I, _P, _P],
    "otbt_hash_columns": [_P, _I, _LL, _P, _P],
    "otbt_route_dest": [_P, _P, _P, _P, _I, _LL, _P, _P, _LL, _I, _P, _P],
    "otbt_compact_scratch_bytes": [_LL, _LL, _LL],
    "otbt_compact": [_P, _LL, _LL, _LL, _P, _LL, _P, _P, _P, _P, _I, _P],
    "otbt_exchange_tiles": [_LL],
    "otbt_exchange_max_dn": [],
    "otbt_exchange_count": [_P, _P, _P, _I, _I, _LL, _P, _P, _P, _P],
    "otbt_fused_scan_agg": [_P, _LL, _P, _P, _P, _I, _P, _P],
    "otbt_exchange_scatter": [_P, _P, _P, _I, _I, _LL, _P, _LL, _P, _P,
                              _P, _P, _P, _I, _P],
    "otbt_exchange_fixed_scratch_bytes": [_P, _I, _I],
    "otbt_exchange_fixed": [_P, _P, _P, _I, _I, _LL, _P, _P, _P, _P, _P, _P,
                            _P, _I, _P, _LL, _P],
    "otbt_ann_distances": [_P, _P, _LL, _I, _I, _I, _P, _P],
    "otbt_ann_probe_scan": [_P, _P, _P, _P, _I, _P, _LL, _I, _I, _I, _P,
                            _P],
    "otbt_ann_topk_scratch_bytes": [_LL, _I],
    "otbt_ann_topk": [_P, _P, _LL, _I, _P, _LL, _P, _P, _P],
    "otbt_ann_assign_scratch_bytes": [_LL, _I, _I, _I],
    "otbt_ann_assign_info": [_I, _P, _P, _P],
    "otbt_ann_assign": [_P, _LL, _P, _I, _I, _I, _P, _LL, _P, _P],
    "otbt_ann_lloyd_scratch_bytes": [_LL, _I, _I],
    "otbt_ann_lloyd_update": [_P, _LL, _I, _P, _P, _I, _P, _P, _P, _LL, _P],
    "otbt_window_bounds": [_P, _I, _I, _LL, _LL] + [_P] * 12,
    "otbt_window_frame_reduce": [_I, _LL] + [_P] * 8 + [_I, _P, _LL, _P, _P,
                                 _I, _D, _P] + [_I] * 3 + [_LL, _I, _LL, _I]
                                + [_P, _LL, _P, _P, _P],
    "otbt_window_scratch_bytes": [_LL, _I, _I],
    "otbt_range_minmax": [_P, _I, _P, _LL, _I, _I, _P, _P],
}
RESTYPES = {"otbt_exchange_tiles": _LL,
            "otbt_sort_scratch_bytes": _LL, "otbt_join_scratch_bytes": _LL,
            "otbt_exchange_max_dn": _LL,
            "otbt_exchange_fixed_scratch_bytes": _LL,
            "otbt_ann_topk_scratch_bytes": _LL,
            "otbt_window_scratch_bytes": _LL,
            "otbt_compact_scratch_bytes": _LL,
            "otbt_ann_assign_scratch_bytes": _LL,
            "otbt_probe_table_bytes": _LL,
            "otbt_join_expand_scratch_bytes": _LL,
            "otbt_group_scratch_bytes": _LL,
            "otbt_grouped_agg_dense_scratch_bytes": _LL,
            "otbt_ann_lloyd_scratch_bytes": _LL}

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when a cached library was loaded)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errs = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errs.append(f"$ {' '.join(c)}\n{out}")
    if errs:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errs))


def build() -> str:
    """Compile csrc/*.cu (in parallel) and link the library; returns its
    path.  Reuses a library built from identical sources."""
    global build_seconds
    so = os.path.join(BUILD_DIR, f"libotbt_kernels_{_digest()}.so")
    if os.path.exists(so):
        build_seconds = 0.0
        return so
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs, cmds = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-3] + f".{os.getpid()}.o")
        objs.append(obj)
        cmds.append([nvcc, *CFLAGS, "-c", src, "-o", obj])
    _run_all(cmds)
    tmp = f"{so[:-3]}.tmp{os.getpid()}.so"
    _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, so)
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, _I)
            _lib = dll
        return _lib
