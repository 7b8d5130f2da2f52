"""The C++ pair loader (native/dataloader.cc) through ctypes.

Port of pulpo_tpu/native/__init__.py. The port keeps its own copy of the
source and builds it with `g++ -O3 -shared -fPIC -std=c++17 -pthread` at
first use (never at import) into `pulpo_tpu_torch/_build/`, named by a
hash of the source and the flags, as `kernels/_build.py` names the CUDA
kernels; nothing is written into the package directory. A failed build
or open raises `NativeUnavailable`, and no caller in the port catches
it: a run that asks for this loader gets it or fails.

`NativeDataset` serves pairs from a volume store (`write_volume_store`,
`convert_h5_to_store`): `epoch` iterates one epoch with the C++ threads
working ahead, `get_pair(index, rng)` serves one item in the schema that
`data/loader.py` collates, so `DataLoader(NativeDataset(...))` and
`prefetch_to_device` feed the Trainer as any reader does. ctypes
releases the GIL while `dl_next` waits, so the C++ copy and one-hot run
beside the training step when the prefetch thread is the caller.

The partner of item `i` is drawn in C++ (a random volume other than
`i`, from the item's seed), not as `data/oasis.py` draws it, and the
one-hot differs from `data/oasis.py:convert_to_onehot` outside the
valid labels: a label outside [0, num_classes) gives an all-zero row
here, while `convert_to_onehot` indexes `np.eye` (an error above the
range, a wrapped row below 0). On valid labels the two agree bit for
bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "dataloader.cc"
BUILD_DIR = SRC.parent.parent / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

MAGIC = 0x50554C504F424C4F


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdataloader_{h}.so"


def _build() -> pathlib.Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"building the native loader failed: {msg}") from e
    os.replace(tmp, lib)
    return lib


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.dl_shape.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.dl_len.restype = ctypes.c_uint64
        lib.dl_len.argtypes = [ctypes.c_void_p]
        lib.dl_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float))] * 4 + [
            ctypes.POINTER(ctypes.c_long)] * 2
        lib.dl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def write_volume_store(path, volumes: np.ndarray, segs: np.ndarray | None = None,
                       num_classes: int = 0):
    """Write a volume store: a 64-byte header, the float32 volumes
    (N, D, H, W), then the int16 label maps if `segs` is given."""
    volumes = np.ascontiguousarray(volumes, dtype=np.float32)
    n = volumes.shape[0]
    shape = volumes.shape[1:]
    assert len(shape) == 3
    seg_flag = num_classes if segs is not None else 0
    header = np.zeros(8, dtype=np.uint64)
    header[0] = MAGIC
    header[1] = n
    header[2:5] = shape
    header[5] = seg_flag
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(volumes.tobytes())
        if segs is not None:
            f.write(np.ascontiguousarray(segs, dtype=np.int16).tobytes())
    return path


class NativeDataset:
    """Pairs from a volume store, copied and one-hot expanded by C++
    threads into `n_slots` preallocated slots (each holds a pair and,
    with `segs`, its two one-hot maps)."""

    def __init__(self, path, segs: bool = False, n_slots: int = 4,
                 n_threads: int = 2, seed: int = 0):
        lib = _load()
        self._lib = lib
        self._h = lib.dl_open(str(path).encode(), int(segs), n_slots)
        if not self._h:
            raise NativeUnavailable(f"dl_open failed for {path}")
        shape = (ctypes.c_uint64 * 3)()
        classes = ctypes.c_uint64()
        lib.dl_shape(self._h, shape, ctypes.byref(classes))
        self.input_size = tuple(int(s) for s in shape)
        self.num_classes = int(classes.value)
        self.segs = segs and self.num_classes > 0
        self.n_threads = n_threads
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return int(self._lib.dl_len(self._h))

    def _start(self, order: np.ndarray, seed: int, n_threads: int) -> None:
        order = np.ascontiguousarray(order, dtype=np.uint32)
        self._lib.dl_start_epoch(
            self._h, order.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(order), seed, n_threads)

    def _items(self):
        """The items of the started epoch, in its order, each copied out
        of its slot before the slot is handed back."""
        lib = self._lib
        voxels = int(np.prod(self.input_size))
        fp = ctypes.POINTER(ctypes.c_float)
        take = lambda p, c: np.ctypeslib.as_array(p, (voxels * c,)).reshape(
            *self.input_size, c).copy()
        while True:
            x_p, y_p, sx_p, sy_p = fp(), fp(), fp(), fp()
            i1, i2 = ctypes.c_long(), ctypes.c_long()
            slot = lib.dl_next(self._h, ctypes.byref(x_p), ctypes.byref(y_p),
                               ctypes.byref(sx_p), ctypes.byref(sy_p),
                               ctypes.byref(i1), ctypes.byref(i2))
            if slot < 0:
                return
            item = {"x": take(x_p, 1), "y": take(y_p, 1), "seg_x": None, "seg_y": None,
                    "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}
            if self.segs and sx_p:
                item["seg_x"] = take(sx_p, self.num_classes)
                item["seg_y"] = take(sy_p, self.num_classes)
            lib.dl_release(self._h, slot)
            yield item

    def epoch(self, shuffle: bool = True, seed: int | None = None):
        """Iterate one epoch of pair items (dicts of numpy arrays); the
        order and the partners' seed come from (seed, epoch number)."""
        n = len(self)
        rng = np.random.default_rng((self.seed if seed is None else seed, self._epoch))
        order = rng.permutation(n) if shuffle else np.arange(n)
        self._epoch += 1
        self._start(order, int(rng.integers(0, 2**63 - 1)), self.n_threads)
        yield from self._items()

    def get_pair(self, index: int, rng: np.random.Generator):
        """One pair: item `index` and a partner drawn from a seed taken
        from `rng` (the DataLoader protocol)."""
        self._start(np.asarray([index]), int(rng.integers(0, 2**63 - 1)), 1)
        return next(self._items())

    def close(self):
        if self._h:
            self._lib.dl_close(self._h)
            self._h = None


def convert_h5_to_store(h5_path, split: str, out_path, with_segs: bool = False):
    """One split of a store in OASIS.h5's layout -> a volume store (with
    its label maps and `seg_dim` classes when `with_segs` and every item
    has one)."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        g = f[split]
        n = int(g.attrs["N"])
        vols = np.stack([np.asarray(g["image"][str(i)], np.float32) for i in range(n)])
        segs = None
        classes = 0
        if with_segs and "seg" in g and len(g["seg"]) == n:
            segs = np.stack([np.asarray(g["seg"][str(i)], np.int16) for i in range(n)])
            classes = int(g.attrs.get("seg_dim", int(segs.max()) + 1))
    return write_volume_store(out_path, vols, segs, classes)
