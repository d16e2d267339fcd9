"""Packed clip shards and their loaders. Port of
counterfactualworldmodels_tpu/data/shards.py (numpy and ctypes; the same
CWMSHARD format and IMU sidecar, byte for byte).

Clips live in one memory-mapped binary shard (format in
``native/clip_loader.cpp``). ``NativeClipLoader`` drives the port's copy of
the C++ loader: a thread pool crops, flips and (for ``out_dtype='f32'``)
converts batches off the Python thread. ``build_native`` compiles it with
``g++`` at first use into ``_build/`` beside the kernels (ignored by git),
never into the source tree. ``PythonClipLoader`` is the pure-numpy loader
with the same semantics.

Both loaders take ``out_dtype``:

- ``'f32'``: float32 [B, T, C, h, w] in [0, 1], normalized on the host.
- ``'u8'``: uint8 [B, T, h, w, C], crop and flip only; ``u8_to_chw_01``
  normalizes and transposes on the device (4x fewer bytes to move).

``open_loader`` picks one without a blanket fallback: the native loader
when a C++ compiler builds it, the Python loader only when there is no
compiler; any other error of the native loader reaches the caller.
Each loader can start its stream at a batch index (``start_batch``), so a
resumed trainer reads the batches the uninterrupted run would have read.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

MAGIC = b'CWMSHARD'
_HEADER = struct.Struct('<8sIIIIII')
IMU_MAGIC = b'CWMIMUSD'
_IMU_HEADER = struct.Struct('<8sIIII')

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, 'data', 'native', 'clip_loader.cpp')
BUILD_DIR = os.path.join(_PKG, '_build')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')


def write_shard(path: str, clips: np.ndarray) -> None:
    """clips: uint8 [N, T, H, W, C] (C <= 4) -> packed shard at ``path``."""
    clips = np.ascontiguousarray(clips)
    if clips.dtype != np.uint8 or clips.ndim != 5:
        raise ValueError(f'clips must be uint8 [N, T, H, W, C], got '
                         f'{clips.dtype} {clips.shape}')
    n, t, h, w, c = clips.shape
    if c > 4:
        raise ValueError(f'clips must be [N, T, H, W, C] (channels last), '
                         f'got C={c}; transpose [N, T, C, H, W] input first')
    if n == 0:
        # the native loader divides by the clip count on its workers
        raise ValueError('refusing to write an empty shard (0 clips)')
    with open(path, 'wb') as f:
        f.write(_HEADER.pack(MAGIC, 1, n, t, h, w, c))
        f.write(clips.tobytes())


def read_shard_header(path: str) -> Tuple[int, int, int, int, int]:
    """(N, T, H, W, C) of a shard."""
    with open(path, 'rb') as f:
        magic, _, n, t, h, w, c = _HEADER.unpack(f.read(_HEADER.size))
    if magic != MAGIC:
        raise ValueError(f'{path} is not a clip shard (magic {magic!r})')
    return n, t, h, w, c


def imu_sidecar_path(path: str) -> str:
    return path + '.imu'


def write_imu_sidecar(shard_path: str, imu: np.ndarray) -> None:
    """Per-clip IMU streams aligned with a clip shard: float32 [N, C, L] at
    ``<shard>.imu``. The loaders give each batch row's source clip index
    (``last_indices``), so sidecar rows follow the shuffle."""
    imu = np.ascontiguousarray(imu, dtype=np.float32)
    if imu.ndim != 3:
        raise ValueError(f'IMU must be [N, C, L], got {imu.shape}')
    n, c, l = imu.shape
    with open(imu_sidecar_path(shard_path), 'wb') as f:
        f.write(_IMU_HEADER.pack(IMU_MAGIC, 1, n, c, l))
        f.write(imu.tobytes())


def read_imu_sidecar(shard_path: str) -> Optional[np.ndarray]:
    """Memory-mapped [N, C, L] float32 IMU sidecar, or None if absent."""
    p = imu_sidecar_path(shard_path)
    if not os.path.exists(p):
        return None
    with open(p, 'rb') as f:
        magic, _, n, c, l = _IMU_HEADER.unpack(f.read(_IMU_HEADER.size))
    if magic != IMU_MAGIC:
        raise ValueError(f'{p} is not an IMU sidecar (magic {magic!r})')
    n_clips = read_shard_header(shard_path)[0]
    if n != n_clips:
        raise ValueError(f'IMU sidecar has {n} rows for a shard of '
                         f'{n_clips} clips')
    return np.memmap(p, dtype=np.float32, mode='r', offset=_IMU_HEADER.size,
                     shape=(n, c, l))


def native_library_path() -> str:
    """The loader library's path: its name hashes the source and flags."""
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    with open(SRC, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'libclip_loader-{digest.hexdigest()[:12]}.so')


def build_native() -> Optional[str]:
    """Compile the C++ loader once (``g++``); returns the library path, or
    None when there is no C++ compiler. A compiler that fails raises with
    its output."""
    out = native_library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    # no -march=native: a library built for one host's CPU must not load
    # on another that shares the checkout (the name hashes no CPU)
    cmd = [cxx, *_FLAGS, SRC, '-o', tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('the native clip loader did not build:\n'
                           f'{" ".join(cmd)}\n{proc.stderr}')
    os.replace(tmp, out)
    return out


class NativeClipLoader:
    """Multithreaded prefetching loader over a packed shard (the port's
    C++ loader). Yields float32 [B, T, C, h, w] batches in [0, 1]
    (``out_dtype='f32'``) or uint8 [B, T, h, w, C] (``'u8'``), in
    batch-index order from ``start_batch``; ``last_indices`` holds the
    source clip of each row of the last batch."""

    def __init__(self, shard_path: str, batch_size: int = 8,
                 crop_size: Optional[Tuple[int, int]] = None,
                 num_threads: int = 2, prefetch: int = 4, seed: int = 0,
                 hflip: bool = False, shuffle: bool = True,
                 out_dtype: str = 'f32', zero_copy: bool = False,
                 start_batch: int = 0):
        if out_dtype not in ('f32', 'u8'):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', "
                             f"got {out_dtype!r}")
        self.out_dtype = out_dtype
        # zero_copy: next_batch returns a view into the loader's ring
        # buffer, valid only until the following next_batch()/close()
        self.zero_copy = zero_copy
        self._held = None
        self._handle = None
        self.library = build_native()
        if self.library is None:
            raise RuntimeError('the native clip loader needs a C++ compiler '
                               '(g++); use PythonClipLoader')
        lib = self._lib = ctypes.CDLL(self.library)
        vp, i, u32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_uint32)
        lib.clip_loader_create_v3.restype = vp
        lib.clip_loader_create_v3.argtypes = [
            ctypes.c_char_p, i, i, i, i, i, ctypes.c_uint64, i, i, i,
            ctypes.c_uint64]
        lib.clip_loader_next_raw.restype = ctypes.c_int64
        lib.clip_loader_next_raw.argtypes = [vp, vp, u32p]
        lib.clip_loader_acquire.restype = ctypes.c_int64
        lib.clip_loader_acquire.argtypes = [vp, ctypes.POINTER(vp), u32p]
        lib.clip_loader_release.argtypes = [vp, vp]
        lib.clip_loader_destroy.argtypes = [vp]
        lib.clip_loader_shape.argtypes = [vp, ctypes.POINTER(i)]
        lib.clip_loader_num_clips.restype = ctypes.c_uint32
        lib.clip_loader_num_clips.argtypes = [vp]
        ch, cw = crop_size if crop_size is not None else (0, 0)
        self._handle = lib.clip_loader_create_v3(
            shard_path.encode(), batch_size, ch, cw, num_threads, prefetch,
            seed, int(hflip), int(shuffle), int(out_dtype == 'u8'),
            start_batch)
        if not self._handle:
            raise RuntimeError(f'failed to open shard {shard_path}')
        shape = (ctypes.c_int * 5)()
        lib.clip_loader_shape(self._handle, shape)
        b, t, c, h, w = tuple(shape)
        self.batch_shape = ((b, t, h, w, c) if out_dtype == 'u8'
                            else (b, t, c, h, w))
        self.num_clips = int(lib.clip_loader_num_clips(self._handle))

    def next_batch(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        dt = np.uint8 if self.out_dtype == 'u8' else np.float32
        ids = np.empty(self.batch_shape[0], dtype=np.uint32)
        ids_p = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if self.zero_copy:
            if self._held is not None:
                self._lib.clip_loader_release(self._handle, self._held)
                self._held = None
            ptr = ctypes.c_void_p()
            idx = self._lib.clip_loader_acquire(self._handle,
                                                ctypes.byref(ptr), ids_p)
            if idx < 0:
                raise StopIteration
            self._held = ptr
            ct = ctypes.c_uint8 if dt == np.uint8 else ctypes.c_float
            out = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ct)),
                shape=(int(np.prod(self.batch_shape)),)).reshape(
                    self.batch_shape)
        else:
            out = np.empty(self.batch_shape, dtype=dt)
            idx = self._lib.clip_loader_next_raw(
                self._handle, out.ctypes.data_as(ctypes.c_void_p), ids_p)
            if idx < 0:
                raise StopIteration
        self.last_indices = ids
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            try:
                batch = self.next_batch()
            except StopIteration:
                return
            yield batch

    def close(self):
        if self._handle:
            if self._held is not None:
                self._lib.clip_loader_release(self._handle, self._held)
                self._held = None
            self._lib.clip_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class PythonClipLoader:
    """The loader in numpy, with the same semantics as the JAX package's
    (its draws from one ``RandomState(seed)``); ``start_batch`` replays the
    draws of the batches before it without reading their clips. The native
    loader's threading and buffer arguments are accepted and unused."""

    def __init__(self, shard_path: str, batch_size: int = 8,
                 crop_size: Optional[Tuple[int, int]] = None, seed: int = 0,
                 hflip: bool = False, shuffle: bool = True,
                 out_dtype: str = 'f32', start_batch: int = 0, **unused):
        if out_dtype not in ('f32', 'u8'):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', "
                             f"got {out_dtype!r}")
        n, t, h, w, c = read_shard_header(shard_path)
        if n == 0:
            raise RuntimeError(f'shard {shard_path} contains 0 clips')
        self.clips = np.memmap(shard_path, dtype=np.uint8, mode='r',
                               offset=_HEADER.size, shape=(n, t, h, w, c))
        self.batch_size = batch_size
        self.crop = crop_size or (h, w)
        self.rng = np.random.RandomState(seed)
        self.hflip = hflip
        self.shuffle = shuffle
        self.out_dtype = out_dtype
        self.num_clips = n
        self.batch_shape = ((batch_size, t, *self.crop, c)
                            if out_dtype == 'u8'
                            else (batch_size, t, c, *self.crop))
        self._pos = 0       # sequential cursor (shuffle=False)
        for _ in range(start_batch * batch_size):
            self._draw()

    def _draw(self):
        """(clip, oy, ox, flip) of the next row."""
        n, _, h, w, _ = self.clips.shape
        ch, cw = self.crop
        if self.shuffle:
            k = self.rng.randint(n)
        else:
            k = self._pos % n
            self._pos += 1
        oy = self.rng.randint(h - ch + 1) if ch < h else 0
        ox = self.rng.randint(w - cw + 1) if cw < w else 0
        flip = bool(self.hflip and self.rng.randint(2))
        return k, oy, ox, flip

    def next_batch(self) -> np.ndarray:
        ch, cw = self.crop
        out = np.empty(self.batch_shape,
                       dtype=np.uint8 if self.out_dtype == 'u8'
                       else np.float32)
        ids = np.empty(self.batch_size, dtype=np.uint32)
        for i in range(self.batch_size):
            k, oy, ox, flip = self._draw()
            ids[i] = k
            clip = self.clips[k, :, oy:oy + ch, ox:ox + cw]
            if flip:
                clip = clip[:, :, ::-1]
            if self.out_dtype == 'u8':
                out[i] = clip
            else:
                out[i] = clip.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
        self.last_indices = ids
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        pass


def open_loader(shard_path: str, **kwargs):
    """The native loader when ``build_native`` gives a library, the Python
    loader only when there is no C++ compiler (with a message saying so).
    Any other failure of the native loader raises."""
    if build_native() is None:
        print('native clip loader unavailable (no C++ compiler): the '
              'Python loader runs', flush=True)
        return PythonClipLoader(shard_path, **kwargs)
    return NativeClipLoader(shard_path, **kwargs)


def u8_to_chw_01(batch) -> torch.Tensor:
    """Device-side normalize for ``out_dtype='u8'`` loader batches: uint8
    [B, T, h, w, C] -> float32 [B, T, C, h, w] in [0, 1]."""
    x = torch.as_tensor(batch)
    return x.float().permute(0, 1, 4, 2, 3) / 255.0
