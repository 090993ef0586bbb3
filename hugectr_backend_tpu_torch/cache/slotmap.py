"""Key -> cache-slot index for the dynamic device embedding caches.

Port of the JAX package's cache/slotmap.py. The reference's dynamic GPU cache
keeps this mapping in CUDA hash tables on the device (reference
backend.cpp:483-491 cache types); here the host owns the index (the port's
native library, ``hps_slotmap_*`` in native/kvstore.cpp) and the device
stores rows at stable slot ids, which K1 gathers. ``PySlotMap`` is the plain
version the tests hold ``NativeSlotMap`` against; the caches never use it.

Semantics:
- ``translate(keys)``: bulk key -> slot; missing keys -> ``miss_slot``
  (== capacity, the default row). Hits refresh LRU ticks.
- ``acquire(keys)``: the insert path; new keys take free slots or evict the
  LRU resident. Returns (slots, evicted_keys).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_KEMPTY = np.int64(np.iinfo(np.int64).min)


class PySlotMap:
    """Plain version of the native map (dict + numpy LRU), for the tests."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.miss_slot = self.capacity
        self._map: dict[int, int] = {}
        self._keys = np.full(self.capacity, _KEMPTY, np.int64)
        self._last = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, -1, -1))
        self._tick = 0
        self._lock = threading.Lock()

    def translate(self, keys: np.ndarray, touch: bool = True) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        out = np.empty(keys.shape[0], np.int32)
        with self._lock:
            self._tick += 1
            for i, k in enumerate(keys.tolist()):
                s = self._map.get(k, -1)
                if s < 0:
                    out[i] = self.miss_slot
                else:
                    out[i] = s
                    if touch:
                        self._last[s] = self._tick
        return out

    def acquire(self, keys: np.ndarray):
        keys = np.asarray(keys, np.int64).reshape(-1)
        slots = np.empty(keys.shape[0], np.int32)
        evicted = np.full(keys.shape[0], _KEMPTY, np.int64)
        if self.capacity <= 0:
            # Zero-capacity map: nothing can be inserted — every key is a
            # non-insert at slot -1 (the native SlotMap does the same;
            # without this, the LRU argmin ran on an empty selection).
            slots.fill(-1)
            return slots, evicted
        with self._lock:
            self._tick += 1
            for i, k in enumerate(keys.tolist()):
                s = self._map.get(k, -1)
                if s >= 0:
                    self._last[s] = self._tick
                    slots[i] = s
                    continue
                if self._free:
                    s = self._free.pop()
                else:
                    resident = self._keys != _KEMPTY
                    s = int(np.flatnonzero(resident)[
                        np.argmin(self._last[resident])
                    ])
                    evicted[i] = self._keys[s]
                    del self._map[int(self._keys[s])]
                self._keys[s] = k
                self._last[s] = self._tick
                self._map[k] = s
                slots[i] = np.int32(s)
        return slots, evicted

    def size(self) -> int:
        return len(self._map)

    def resident(self):
        with self._lock:
            mask = self._keys != _KEMPTY
            return self._keys[mask].copy(), np.flatnonzero(mask).astype(np.int32)


class NativeSlotMap:
    """ctypes binding over hps_slotmap_* (native/kvstore.cpp)."""

    def __init__(self, capacity: int):
        from hugectr_backend_tpu_torch.native.kvstore import load_lib

        self.lib = load_lib()
        self.capacity = int(capacity)
        self.miss_slot = self.capacity
        self.handle = self.lib.hps_slotmap_create(self.capacity)

    def __del__(self):
        handle = getattr(self, "handle", None)
        if handle:
            self.lib.hps_slotmap_destroy(handle)
            self.handle = None

    def translate(self, keys: np.ndarray, touch: bool = True) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        out = np.empty(keys.shape[0], np.int32)
        self.lib.hps_slotmap_translate(
            self.handle, keys.shape[0],
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.miss_slot, 1 if touch else 0,
        )
        return out

    def acquire(self, keys: np.ndarray):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        slots = np.empty(keys.shape[0], np.int32)
        evicted = np.empty(keys.shape[0], np.int64)
        self.lib.hps_slotmap_acquire(
            self.handle, keys.shape[0],
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            evicted.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return slots, evicted

    def size(self) -> int:
        return int(self.lib.hps_slotmap_size(self.handle))

    def resident(self):
        n = self.size()
        keys = np.empty(max(n, 1), np.int64)
        slots = np.empty(max(n, 1), np.int32)
        w = self.lib.hps_slotmap_keys(
            self.handle,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
        )
        return keys[:w], slots[:w]


def make_slotmap(capacity: int) -> NativeSlotMap:
    """The caches' slot map: the native one (a failed build raises)."""
    return NativeSlotMap(capacity)


def translate_slotmaps_batch(slotmaps, keys_list, touch: bool = True):
    """Translate a whole multi-table request through the caches' SlotMaps in
    ONE native call: one pool unit per table, parallel across tables (each
    SlotMap serializes on its own C++ mutex). LRU-touch semantics identical
    to per-map ``translate``. -> list of int32 slot arrays."""
    if not slotmaps:
        return []
    from hugectr_backend_tpu_torch.native.kvstore import batch_translate_args

    outs, args, keepalive = batch_translate_args(
        [m.handle for m in slotmaps], keys_list, [m.miss_slot for m in slotmaps])
    slotmaps[0].lib.hps_slotmap_translate_batch(*args, 1 if touch else 0)
    del keepalive
    return outs
