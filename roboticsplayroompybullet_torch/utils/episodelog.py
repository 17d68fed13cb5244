"""Play-episode store: ctypes bindings to the native C++ logger — the
port's own copy of roboticsplayroompybullet_tpu/utils/episodelog.py (numpy
and ctypes only; the two read and write the same files).

Role parity: the reference's purpose is generating + replaying teleoperated
play episodes (reference README.md:2-10; vr_data_collection.py writes,
learning_from_play replays). Here episodes are collected by batched
scripted play or MPC on the card (tools/collect_play_torch.py), and the
storage/replay runtime is native C++ (native/episodelog.cpp) — append-only
binary chunks, O(1) random-access index, numpy round-trip.

Falls back to a pure-numpy .npz implementation when the shared library
hasn't been built (`make -C native`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libepisodelog.so")
_lib = None


def _load_lib(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path) and build:
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)],
                           check=True, capture_output=True)
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.elog_create.restype = ctypes.c_void_p
    lib.elog_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                ctypes.POINTER(ctypes.c_uint32)]
    lib.elog_begin_episode.argtypes = [ctypes.c_void_p]
    lib.elog_append_step.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.elog_append_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint32]
    lib.elog_end_episode.argtypes = [ctypes.c_void_p]
    lib.elog_close_writer.argtypes = [ctypes.c_void_p]
    lib.elog_open.restype = ctypes.c_void_p
    lib.elog_open.argtypes = [ctypes.c_char_p]
    for name in ("elog_num_episodes", "elog_num_fields"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.elog_field_dim.restype = ctypes.c_int64
    lib.elog_field_dim.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.elog_episode_len.restype = ctypes.c_int64
    lib.elog_episode_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.elog_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_uint32,
                              ctypes.POINTER(ctypes.c_float)]
    lib.elog_close_reader.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class EpisodeWriter:
    """Schema: ordered {field: dim}. Appends (T, dim) float32 batches."""

    def __init__(self, path: str, fields: Dict[str, int]):
        self.fields = dict(fields)
        self._names = list(fields)
        self._lib = _load_lib()
        self._native = self._lib is not None
        if self._native:
            dims = (ctypes.c_uint32 * len(fields))(*fields.values())
            self._h = self._lib.elog_create(path.encode(), len(fields), dims)
            if not self._h:
                raise IOError(f"cannot create {path}")
        else:
            self._path = path
            self._episodes: List[Dict[str, np.ndarray]] = []
        self._open_ep: Optional[Dict[str, List[np.ndarray]]] = None

    def begin_episode(self):
        if self._native:
            self._lib.elog_begin_episode(self._h)
        self._open_ep = {k: [] for k in self._names}

    def append_batch(self, data: Dict[str, np.ndarray]):
        """data[field]: (T, dim) float32; same T across fields."""
        arrs = {k: np.ascontiguousarray(np.asarray(data[k], np.float32))
                for k in self._names}
        T = next(iter(arrs.values())).shape[0]
        if self._native:
            ptrs = (ctypes.POINTER(ctypes.c_float) * len(self._names))(*[
                a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                for a in (arrs[k] for k in self._names)])
            self._lib.elog_append_batch(self._h, ptrs, T)
        else:
            for k in self._names:
                self._open_ep[k].append(arrs[k])

    def end_episode(self):
        if self._native:
            if self._lib.elog_end_episode(self._h) != 0:
                raise IOError("episode log write failed (disk full?)")
        else:
            self._episodes.append({
                k: (np.concatenate(v) if v else
                    np.zeros((0, self.fields[k]), np.float32))
                for k, v in self._open_ep.items()})
        self._open_ep = None

    def close(self):
        if self._native:
            rc = self._lib.elog_close_writer(self._h)
            self._h = None
            if rc != 0:
                raise IOError("episode log close failed (truncated write)")
        else:
            flat = {}
            for i, ep in enumerate(self._episodes):
                for k, v in ep.items():
                    flat[f"ep{i}_{k}"] = v
            flat["__meta__"] = np.asarray(
                [len(self._episodes)] + [self.fields[k] for k in self._names])
            flat["__names__"] = np.asarray(self._names)
            # open file handle: np.savez(path) appends '.npz' when the
            # path lacks it, which would break EpisodeReader(path)
            with open(self._path, "wb") as f:
                np.savez(f, **flat)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EpisodeReader:
    def __init__(self, path: str, fields: Optional[Sequence[str]] = None):
        self._lib = _load_lib(build=True)
        self._native = (self._lib is not None
                        and not path.endswith(".npz"))
        if self._native:
            self._h = self._lib.elog_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
            self.n_episodes = int(self._lib.elog_num_episodes(self._h))
            n_fields = int(self._lib.elog_num_fields(self._h))
            self.dims = [int(self._lib.elog_field_dim(self._h, i))
                         for i in range(n_fields)]
            self.names = list(fields) if fields else [
                f"field{i}" for i in range(n_fields)]
        else:
            data = np.load(path, allow_pickle=False)
            self.names = [str(x) for x in data["__names__"]]
            meta = data["__meta__"]
            self.n_episodes = int(meta[0])
            self.dims = [int(d) for d in meta[1:]]
            self._eps = [{k: data[f"ep{i}_{k}"] for k in self.names}
                         for i in range(self.n_episodes)]

    def episode_len(self, ep: int) -> int:
        if self._native:
            return int(self._lib.elog_episode_len(self._h, ep))
        return next(iter(self._eps[ep].values())).shape[0]

    def read(self, ep: int, field: str) -> np.ndarray:
        fi = self.names.index(field)
        if not self._native:
            return self._eps[ep][field]
        T = self.episode_len(ep)
        out = np.empty((T, self.dims[fi]), np.float32)
        rc = self._lib.elog_read(
            self._h, ep, fi, out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"read failed ep={ep} field={field}")
        return out

    def read_episode(self, ep: int) -> Dict[str, np.ndarray]:
        return {k: self.read(ep, k) for k in self.names}

    def close(self):
        if self._native and self._h:
            self._lib.elog_close_reader(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
