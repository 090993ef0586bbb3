"""Build, load and bind the native host library (``kvstore.cpp``,
``shm_kvstore.cpp``): the DRAM stores, the static key index, the quantizer and
the front end's request merge.

Port of the JAX package's native/kvstore.py. The two sources are this
package's own copies; they are compiled at first use, never on import, into
one shared library:

    g++ -O3 -march=native -std=c++17 -fPIC -pthread -shared \
        -o _build/libhps_native-<hash>.so kvstore.cpp shm_kvstore.cpp

The file name carries a hash of the sources, the flags and the host CPU
(``-march=native`` code must not run on another CPU), so an edited source is
rebuilt and a stale or foreign library is never loaded. A build writes a
private temporary file and publishes it with ``os.replace``, so processes that
build at once each load a whole library. A failed build raises; nothing falls
back to numpy.

    NativeDramKVTier        hash_map / parallel_hash_map (kvstore.cpp)
    SharedMemoryDramKVTier  multi_process_hash_map: one /dev/shm segment per
                            table, shared by every process on the host
    batch_translate_args    argument layout of the ``*_translate_batch`` calls

The ``hps_slotmap_*`` (dynamic caches) and ``hps_snappy_raw`` (compressed
updates) symbols are built but not bound: their callers are not ported yet
(ROADMAP queue A item 3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import (
    DatabaseOverflowPolicy,
    VolatileDatabaseParams,
)
from hugectr_backend_tpu_torch.tiers.base import KVTier

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("kvstore.cpp", "shm_kvstore.cpp")
#: The JAX package's flags (its native/Makefile), warnings aside.
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")
_POLICY_CODE = {
    DatabaseOverflowPolicy.EVICT_RANDOM: 0,
    DatabaseOverflowPolicy.EVICT_LEAST_USED: 1,
    DatabaseOverflowPolicy.EVICT_OLDEST: 2,
}

_lib = None
_lib_lock = threading.Lock()


def _host_cpu() -> bytes:
    """The CPU that ``-march=native`` compiles for: its model and flags."""
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    sig += "|" + line.strip()
                elif not line.strip() and "|" in sig:
                    break  # the first CPU is enough
    except OSError:
        pass
    return sig.encode()


def target(build_dir: Path = BUILD_DIR) -> Path:
    """Path of the library for these sources, flags and CPU."""
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu())
    return Path(build_dir) / f"libhps_native-{h.hexdigest()[:12]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless it is there. -> its path. Raises when
    ``g++`` is missing or fails."""
    out = target(build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native library of "
            "hugectr_backend_tpu_torch is built from native/*.cpp at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "g++ failed for native/kvstore.cpp + shm_kvstore.cpp:\n"
            + proc.stderr.decode(errors="replace"))
    os.replace(tmp, out)
    return out


def _fn(lib, name, restype, *argtypes):
    f = getattr(lib, name)
    f.restype = restype
    f.argtypes = list(argtypes)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of every bound symbol."""
    c = ctypes
    vp, i64, i32 = c.c_void_p, c.c_int64, c.c_int32
    pi64, pi32 = c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    pf32, pu8 = c.POINTER(c.c_float), c.POINTER(c.c_uint8)
    # kvstore.cpp: the partitioned store.
    _fn(lib, "hps_kv_create", vp, c.c_int, c.c_int, c.c_uint64, c.c_int, c.c_double)
    _fn(lib, "hps_kv_destroy", None, vp)
    _fn(lib, "hps_kv_insert", None, vp, i64, pi64, pf32)
    _fn(lib, "hps_kv_query", None, vp, i64, pi64, pf32, pu8)
    _fn(lib, "hps_kv_evict", i64, vp, i64, pi64)
    _fn(lib, "hps_kv_size", i64, vp)
    _fn(lib, "hps_kv_keys", i64, vp, pi64, i64)
    # shm_kvstore.cpp: the shared-memory store.
    _fn(lib, "hps_shmkv_open", vp, c.c_char_p, c.c_int, c.c_int, c.c_uint64, c.c_int,
        c.c_double, c.c_int)
    _fn(lib, "hps_shmkv_close", None, vp)
    _fn(lib, "hps_shmkv_unlink", c.c_int, c.c_char_p)
    _fn(lib, "hps_shmkv_insert", None, vp, i64, pi64, pf32)
    _fn(lib, "hps_shmkv_query", None, vp, i64, pi64, pf32, pu8)
    _fn(lib, "hps_shmkv_evict", i64, vp, i64, pi64)
    _fn(lib, "hps_shmkv_size", i64, vp)
    _fn(lib, "hps_shmkv_capacity", i64, vp)
    _fn(lib, "hps_shmkv_keys", i64, vp, pi64, i64)
    # kvstore.cpp: the static key index (tiers/hbm.py KeyIndex).
    _fn(lib, "hps_statmap_create", vp, i64, pi64)
    _fn(lib, "hps_statmap_destroy", None, vp)
    _fn(lib, "hps_statmap_nbytes", i64, vp)
    _fn(lib, "hps_statmap_translate", None, vp, i64, pi64, pi32, i32)
    _fn(lib, "hps_statmap_translate_batch", None, i32, c.POINTER(vp), pi64,
        c.POINTER(pi64), c.POINTER(pi32), pi32)
    # kvstore.cpp: the single-pass quantizer (ops/quantize.py).
    _fn(lib, "hps_quantize_rows", None, i64, i32, pf32, pi64, vp, pf32, i32)
    # kvstore.cpp: the batcher's merge and regroup (serving/batchpack.py).
    _fn(lib, "hps_merge_requests", None, i32, i32, c.POINTER(vp), vp, vp, vp)
    _fn(lib, "hps_regroup_responses", None, i32, i32, vp, vp, vp, vp, vp)
    return lib


def load_lib() -> ctypes.CDLL:
    """The loaded, bound library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class _NativeTable:
    def __init__(self, lib, dim: int, params: VolatileDatabaseParams):
        self.lib = lib
        self.dim = dim
        self.handle = lib.hps_kv_create(
            dim,
            params.effective_num_partitions(),
            min(params.overflow_margin, 2**63 - 1),
            _POLICY_CODE[params.overflow_policy],
            params.overflow_resolution_target,
        )

    def __del__(self):
        self.lib.hps_kv_destroy(self.handle)


class NativeDramKVTier(KVTier):
    """The default volatile store (``hash_map`` / ``parallel_hash_map``):
    the numpy :class:`~hugectr_backend_tpu_torch.tiers.dram.DramKVTier`'s
    semantics, in C++."""

    def __init__(self, params: Optional[VolatileDatabaseParams] = None):
        self.params = params or VolatileDatabaseParams()
        self.lib = load_lib()
        self._tables: dict[str, _NativeTable] = {}
        self._lock = threading.Lock()

    def create_table(self, tag: str, dim: int) -> None:
        with self._lock:
            if tag in self._tables:
                if self._tables[tag].dim != dim:
                    raise ValueError(
                        f"table {tag} exists with dim {self._tables[tag].dim}, "
                        f"requested {dim}")
                return
            self._tables[tag] = _NativeTable(self.lib, dim, self.params)

    def drop_table(self, tag: str) -> None:
        with self._lock:
            self._tables.pop(tag, None)

    def tables(self) -> list[str]:
        return list(self._tables.keys())

    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32).reshape(
            keys.shape[0], -1)
        if tag not in self._tables:
            self.create_table(tag, int(vectors.shape[1]))
        t = self._tables[tag]
        if vectors.shape[1] != t.dim:
            raise ValueError(f"dim mismatch: table {t.dim}, vectors {vectors.shape[1]}")
        self.lib.hps_kv_insert(t.handle, keys.shape[0], _i64p(keys), _f32p(vectors))
        return int(keys.shape[0])

    def query(self, tag: str, keys: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        t = self._tables[tag]
        out = np.empty((keys.shape[0], t.dim), dtype=np.float32)
        found = np.empty(keys.shape[0], dtype=np.uint8)
        self.lib.hps_kv_query(t.handle, keys.shape[0], _i64p(keys), _f32p(out),
                              _u8p(found))
        return out, found.astype(bool)

    def evict(self, tag: str, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        t = self._tables[tag]
        return int(self.lib.hps_kv_evict(t.handle, keys.shape[0], _i64p(keys)))

    def size(self, tag: str) -> int:
        return int(self.lib.hps_kv_size(self._tables[tag].handle))

    def keys(self, tag: str) -> np.ndarray:
        t = self._tables[tag]
        n = self.size(tag)
        out = np.empty(max(n, 1), dtype=np.int64)
        w = self.lib.hps_kv_keys(t.handle, _i64p(out), n)
        return out[:w]


def _shm_segment_name(base: str, tag: str) -> str:
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in tag)
    return f"/{base.lstrip('/')}.{safe}"[:250]


class _ShmTable:
    def __init__(self, lib, name: str, dim: int, params: VolatileDatabaseParams):
        self.lib = lib
        self.name = name
        self.dim = dim
        # Capacity from the shared-memory budget: rows + index overhead
        # (~dim*4 + 44 bytes/row + 2x hash slots of 12B), as the reference
        # sizes the map from `shared_memory_size` (doc:417-421).
        row_bytes = dim * 4 + 44 + 24
        budget_rows = max(int(params.shared_memory_size) // row_bytes, 16)
        cap = min(budget_rows, int(min(params.overflow_margin, 2**62)))
        self.handle = lib.hps_shmkv_open(
            name.encode(), dim, params.effective_num_partitions(),
            cap, _POLICY_CODE[params.overflow_policy],
            params.overflow_resolution_target, 1,
        )
        if not self.handle:
            raise OSError(
                f"failed to open shared-memory segment {name} "
                f"(geometry mismatch with an existing segment?)")

    def close(self, unlink: bool):
        if self.handle:
            self.lib.hps_shmkv_close(self.handle)
            self.handle = None
        if unlink:
            self.lib.hps_shmkv_unlink(self.name.encode())

    def __del__(self):
        if self.handle:
            self.lib.hps_shmkv_close(self.handle)


class SharedMemoryDramKVTier(KVTier):
    """``multi_process_hash_map``: one /dev/shm segment per table, shared by
    every serving process on the host (reference
    docs/hierarchical_parameter_server.md:404,417-421). Config keys honored:
    ``shared_memory_size`` (capacity budget), ``shared_memory_name`` (segment
    prefix), ``shared_memory_auto_remove`` (unlink on drop/close)."""

    def __init__(self, params: Optional[VolatileDatabaseParams] = None):
        self.params = params or VolatileDatabaseParams()
        self.lib = load_lib()
        self._tables: dict[str, _ShmTable] = {}
        self._lock = threading.Lock()

    def create_table(self, tag: str, dim: int) -> None:
        with self._lock:
            if tag in self._tables:
                if self._tables[tag].dim != dim:
                    raise ValueError(
                        f"table {tag} exists with dim {self._tables[tag].dim}, "
                        f"requested {dim}")
                return
            name = _shm_segment_name(self.params.shared_memory_name, tag)
            self._tables[tag] = _ShmTable(self.lib, name, dim, self.params)

    def drop_table(self, tag: str) -> None:
        with self._lock:
            t = self._tables.pop(tag, None)
            if t is not None:
                t.close(unlink=self.params.shared_memory_auto_remove)

    def tables(self) -> list[str]:
        return list(self._tables.keys())

    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32).reshape(
            keys.shape[0], -1)
        if tag not in self._tables:
            self.create_table(tag, int(vectors.shape[1]))
        t = self._tables[tag]
        if vectors.shape[1] != t.dim:
            raise ValueError(f"dim mismatch: table {t.dim}, vectors {vectors.shape[1]}")
        self.lib.hps_shmkv_insert(t.handle, keys.shape[0], _i64p(keys), _f32p(vectors))
        return int(keys.shape[0])

    def query(self, tag: str, keys: np.ndarray):
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        t = self._tables[tag]
        out = np.empty((keys.shape[0], t.dim), dtype=np.float32)
        found = np.empty(keys.shape[0], dtype=np.uint8)
        self.lib.hps_shmkv_query(t.handle, keys.shape[0], _i64p(keys), _f32p(out),
                                 _u8p(found))
        return out, found.astype(bool)

    def evict(self, tag: str, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        t = self._tables[tag]
        return int(self.lib.hps_shmkv_evict(t.handle, keys.shape[0], _i64p(keys)))

    def size(self, tag: str) -> int:
        return int(self.lib.hps_shmkv_size(self._tables[tag].handle))

    def capacity(self, tag: str) -> int:
        return int(self.lib.hps_shmkv_capacity(self._tables[tag].handle))

    def keys(self, tag: str) -> np.ndarray:
        t = self._tables[tag]
        n = self.size(tag)
        out = np.empty(max(n, 1), dtype=np.int64)
        w = self.lib.hps_shmkv_keys(t.handle, _i64p(out), n)
        return out[:w]

    def close(self) -> None:
        with self._lock:
            for t in self._tables.values():
                t.close(unlink=self.params.shared_memory_auto_remove)
            self._tables.clear()


def batch_translate_args(handles, keys_list, miss_slots):
    """Marshal the shared argument layout of the ``*_translate_batch`` C calls
    (per-table handle/count/key-pointer/out-pointer/miss arrays).

    -> (out_arrays, argtuple, keepalive): pass ``*argtuple`` to the C call
    (it covers every parameter up to and including the miss pointer) and
    hold ``keepalive`` until it returns (it owns the counts/miss numpy
    buffers the pointers reference).
    """
    n = len(handles)
    keys_c = [np.ascontiguousarray(k, np.int64).reshape(-1) for k in keys_list]
    outs = [np.empty(k.shape[0], np.int32) for k in keys_c]
    h = (ctypes.c_void_p * n)(*handles)
    counts = np.array([k.shape[0] for k in keys_c], np.int64)
    miss = np.asarray(miss_slots, np.int32)
    kp = (ctypes.POINTER(ctypes.c_int64) * n)(
        *[k.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) for k in keys_c])
    op = (ctypes.POINTER(ctypes.c_int32) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for o in outs])
    args = (
        n, h,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        kp, op,
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return outs, args, (keys_c, counts, miss)
