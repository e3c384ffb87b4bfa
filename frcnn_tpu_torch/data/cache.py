"""Memory-mapped image caches (``frcnn_tpu/data/cache.py``): each image is
read once into one flat uint8 file plus a pickled index, then served as
zero-copy ``np.memmap`` views.

  * ``DecodedImageCache``: the decoded images.  ``cache.reader`` is a reader
    (image path → BGR uint8 array) for ``get_minibatch`` and the layers.
  * ``ResizedImageCache``: each (image, target scale) at its final training
    size, uint8.  Passed as the reader, it turns a batch's host work into
    views and one uint8 pad, and the batch goes to the card as uint8 (the
    cast and the mean subtraction run in the model).  Flips are not cached:
    ``get_minibatch`` flips the resized view with a negative stride.

The on-disk layout is the JAX package's, so either package opens the
other's cache: ``<prefix>.dat`` holds the raw BGR bytes, ``<prefix>.idx``
pickles ``{path: (offset, h, w, c, mtime, fsize)}`` (decoded) or
``{(path, target): (offset, sh, sw, h, w, scale, mtime, fsize)}`` (resized).
``build`` reuses an existing cache only when it covers every requested
entry and each source file keeps the (mtime, size) recorded at the build
(and, resized, the scale the live MAX_SIZE and BUCKETS give); else it
rebuilds.  ``ResizedImageCache.get`` returns None where the live config
gives another scale.

Two changes from the JAX package: ``build`` reads through ``reader``
(default ``loader.read_image``) where the JAX package calls
``cv2.imread``, and the resize is ``loader.resize_bilinear`` (cv2's
sampling in numpy) rounded to uint8, within 1 LSB of ``cv2.resize``: no
cv2 is needed where a reader serves the pixels.

Turn it on in training with ``TRAIN.IMAGE_CACHE`` (``--set TRAIN.IMAGE_CACHE
True``): the trainer builds a ``ResizedImageCache`` under
``<DATA_DIR>/cache/<imdb>_resized``, shared by every experiment on that
dataset, as the roidb caches are.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import time

import numpy as np

from frcnn_tpu_torch.data import loader


def _read(reader, path):
    im = (reader or loader.read_image)(path)
    if im is None:
        raise ValueError(f"failed to read {path}")
    return np.ascontiguousarray(im, dtype=np.uint8)


def _load_index(cache_prefix):
    with open(cache_prefix + ".idx", "rb") as f:
        return pickle.load(f)


def _source_current(path, mtime, fsize) -> bool:
    """The source file still has the (mtime, size) recorded at the build."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    return st.st_mtime == mtime and st.st_size == fsize


class DecodedImageCache:
    """Decode-once memmap image store; ``cache.reader`` serves BGR uint8
    views."""

    def __init__(self, dat_path: str, index: dict):
        self._dat_path = dat_path
        self._index = index
        self._mm = np.memmap(dat_path, dtype=np.uint8, mode="r")

    @classmethod
    def build(cls, image_paths, cache_prefix: str, reader=None, verbose: bool = True):
        """Read every unique path through ``reader`` into
        ``<cache_prefix>.dat/.idx``, or reuse the cache there when it is
        current for every path."""
        dat, idx = cache_prefix + ".dat", cache_prefix + ".idx"
        unique = list(dict.fromkeys(image_paths))
        if osp.exists(dat) and osp.exists(idx):
            index = _load_index(cache_prefix)
            if all(p in index and _source_current(p, *index[p][4:]) for p in unique):
                if verbose:
                    print(f"image cache: reusing {dat} ({len(index)} images)")
                return cls(dat, index)
            if verbose:
                print("image cache: stale or incomplete — rebuilding")
        os.makedirs(osp.dirname(osp.abspath(dat)), exist_ok=True)
        index, offset, t0 = {}, 0, time.perf_counter()
        with open(dat, "wb") as f:
            for p in unique:
                im = _read(reader, p)
                f.write(im.tobytes())
                st = os.stat(p)
                index[p] = (offset, *im.shape, st.st_mtime, st.st_size)
                offset += im.nbytes
        with open(idx, "wb") as f:
            pickle.dump(index, f)
        if verbose:
            print(f"image cache: built {dat} ({len(unique)} images, {offset / 1e6:.1f} MB) "
                  f"in {time.perf_counter() - t0:.3f} s")
        return cls(dat, index)

    @classmethod
    def open(cls, cache_prefix: str):
        return cls(cache_prefix + ".dat", _load_index(cache_prefix))

    def __contains__(self, path: str) -> bool:
        return path in self._index

    def reader(self, path: str) -> np.ndarray:
        """(H, W, C) uint8 BGR view of the cached image of ``path``."""
        offset, h, w, c = self._index[path][:4]
        return self._mm[offset:offset + h * w * c].reshape(h, w, c)


class ResizedImageCache:
    """Read-and-resize-once memmap store: each (path, target scale) at its
    training size, uint8 BGR.  Pass the cache itself as ``get_minibatch``'s
    (or a layer's) reader."""

    def __init__(self, dat_path: str, index: dict):
        self._dat_path = dat_path
        self._index = index
        self._mm = np.memmap(dat_path, dtype=np.uint8, mode="r")

    @staticmethod
    def _scale_for(h, w, target, max_size, buckets):
        return loader.pick_scale_and_bucket(h, w, target, max_size, buckets)[0]

    @classmethod
    def build(cls, image_paths, cache_prefix: str, targets, max_size: int, buckets,
              reader=None, verbose: bool = True):
        """Read every unique path through ``reader`` and store it resized at
        every target scale in ``<cache_prefix>.dat/.idx``, or reuse the cache
        there when it covers every (path, target), each source is unchanged
        and the recorded scales are the live (MAX_SIZE, BUCKETS)'s."""
        dat, idx = cache_prefix + ".dat", cache_prefix + ".idx"
        unique = list(dict.fromkeys(image_paths))
        targets = tuple(dict.fromkeys(targets))

        def current(p, t, entry):
            _, _, _, h, w, scale, mtime, fsize = entry
            return (_source_current(p, mtime, fsize)
                    and scale == cls._scale_for(h, w, t, max_size, buckets))

        if osp.exists(dat) and osp.exists(idx):
            index = _load_index(cache_prefix)
            if all((p, t) in index and current(p, t, index[(p, t)])
                   for p in unique for t in targets):
                if verbose:
                    print(f"resized-image cache: reusing {dat} ({len(index)} entries)")
                return cls(dat, index)
            if verbose:
                print("resized-image cache: stale or incomplete — rebuilding")
        os.makedirs(osp.dirname(osp.abspath(dat)), exist_ok=True)
        index, offset, t0 = {}, 0, time.perf_counter()
        with open(dat, "wb") as f:
            for p in unique:
                im = _read(reader, p)
                h, w = im.shape[:2]
                st = os.stat(p)
                for t in targets:
                    scale = cls._scale_for(h, w, t, max_size, buckets)
                    r = np.clip(np.rint(loader.resize_bilinear(im, scale)), 0, 255).astype(np.uint8)
                    f.write(r.tobytes())
                    index[(p, t)] = (offset, r.shape[0], r.shape[1], h, w, scale,
                                     st.st_mtime, st.st_size)
                    offset += r.nbytes
        with open(idx, "wb") as f:
            pickle.dump(index, f)
        if verbose:
            print(f"resized-image cache: built {dat} ({len(unique)} images x {len(targets)} "
                  f"scales, {offset / 1e6:.1f} MB) in {time.perf_counter() - t0:.3f} s")
        return cls(dat, index)

    @classmethod
    def open(cls, cache_prefix: str):
        return cls(cache_prefix + ".dat", _load_index(cache_prefix))

    def get(self, path: str, target, max_size: int, buckets):
        """(resized uint8 BGR view (sh, sw, 3), scale), or None when the
        entry is absent or its scale is not the live config's."""
        entry = self._index.get((path, target))
        if entry is None:
            return None
        offset, sh, sw, h, w, scale, _, _ = entry
        if scale != self._scale_for(h, w, target, max_size, buckets):
            return None
        return self._mm[offset:offset + sh * sw * 3].reshape(sh, sw, 3), scale
