"""The port's image caches (``frcnn_tpu_torch/data/cache.py``) and the
cached route of ``get_minibatch`` against the JAX package's, on the CPU,
over the ``voc_root`` devkit (six JPEGs of 240-320 x 320-400) and its
flipped entries:

  * ``DecodedImageCache.reader`` is bit-equal to JAX's;
  * ``ResizedImageCache``: the same index (shapes, sizes, offsets, scales
    exactly), pixels within 1 LSB of JAX's (the port resizes in numpy, JAX
    with ``cv2.resize``: ``test_resize_within_bound_of_cv2``'s bound);
  * the same file format both ways: each package opens the other's cache
    and returns its bytes exactly, and reuses it without reading an image;
  * staleness: an unchanged cache is reused (0 reads), a touched source
    rebuilds it, and a changed MAX_SIZE makes ``get`` return None, so the
    batch falls back to the f32 route;
  * ``get_minibatch`` through the port's cache against JAX's through JAX's,
    4 batches with flipped entries: uint8, ``im_info`` and ``gt_boxes``
    exact, ``data`` within 1 LSB; against the port's uncached f32 route,
    ``data`` within 2.0 (JAX's own bound, ``tests/test_data.py``) where a
    flipped view samples the points of the flipped image's resize (the
    test's docstring says where it does not, for both packages).
"""

import copy
import os
import os.path as osp

import numpy as np
import pytest

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.data import cache as jax_cache
from frcnn_tpu.data.loader import RoIDataLayer as JaxRoIDataLayer
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data import cache, loader
from frcnn_tpu_torch.data.loader import RoIDataLayer, get_minibatch
from frcnn_tpu_torch.data.pascal_voc import pascal_voc
from frcnn_tpu_torch.data.roidb import prepare_roidb

CFG = ["TPU.BUCKETS", "((256, 320), (320, 448))", "TRAIN.SCALES", "(200,)",
       "TRAIN.MAX_SIZE", "400", "TRAIN.IMS_PER_BATCH", "2", "TRAIN.NATIVE_PREP", "False"]
TARGETS = (200, 240)                 # the second scale: a cache of several targets


@pytest.fixture(scope="module")
def roidb(voc_root, tmp_path_factory):
    """The trainval roidb with its flipped entries (12 entries), sizes stored."""
    root, _ = voc_root
    ds = pascal_voc("trainval", "2007", devkit_path=osp.join(root, "VOCdevkit2007"),
                    data_dir=str(tmp_path_factory.mktemp("cache_roidb")))
    prepare_roidb(ds)
    ds.append_flipped_images()
    return ds.roidb


def _paths(roidb):
    return list(dict.fromkeys(e["image"] for e in roidb))


def _resized(kind, paths, prefix, cfg, reader=None):
    """A resized cache of ``paths`` built by the port or by JAX."""
    kw = dict(targets=TARGETS, max_size=cfg.TRAIN.MAX_SIZE, buckets=cfg.DEVICE.BUCKETS,
              verbose=False)
    if kind == "port":
        return cache.ResizedImageCache.build(paths, prefix, reader=reader, **kw)
    return jax_cache.ResizedImageCache.build(paths, prefix, **kw)


def _refuse(path):
    raise AssertionError(f"read {path}: the cache should have been reused")


def test_decoded_cache_reader_is_bit_equal_to_jax(roidb, tmp_path):
    paths = _paths(roidb)
    ours = cache.DecodedImageCache.build(paths, str(tmp_path / "port"), verbose=False)
    theirs = jax_cache.DecodedImageCache.build(paths, str(tmp_path / "jax"), verbose=False)
    reopened = cache.DecodedImageCache.open(str(tmp_path / "port"))
    for p in paths:
        want = theirs.reader(p)
        assert p in ours and want.dtype == np.uint8
        np.testing.assert_array_equal(ours.reader(p), want)
        np.testing.assert_array_equal(reopened.reader(p), want)
    with open(tmp_path / "port.dat", "rb") as a, open(tmp_path / "jax.dat", "rb") as b:
        assert a.read() == b.read()


def test_resized_cache_within_one_lsb_of_jax_and_scales_exact(roidb, tmp_path):
    cfg = cfg_from_list(default_config(), CFG)
    paths = _paths(roidb)
    ours = _resized("port", paths, str(tmp_path / "port"), cfg)
    theirs = _resized("jax", paths, str(tmp_path / "jax"), cfg)
    assert ours._index == theirs._index              # offsets, sizes, scales, (mtime, size)
    resized = 0
    for p in paths:
        for t in TARGETS:
            a, sa = ours.get(p, t, cfg.TRAIN.MAX_SIZE, cfg.DEVICE.BUCKETS)
            b, sb = theirs.get(p, t, cfg.TRAIN.MAX_SIZE, cfg.DEVICE.BUCKETS)
            assert sa == sb and a.shape == b.shape and a.dtype == b.dtype == np.uint8
            assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
            resized += sa != 1.0
    assert resized >= len(paths)                     # 200 resizes every image, 240 some


@pytest.mark.parametrize("kind", ["decoded", "resized"])
def test_each_package_opens_the_others_cache(roidb, tmp_path, kind):
    cfg = cfg_from_list(default_config(), CFG)
    paths = _paths(roidb)
    for maker, opener in (("jax", "port"), ("port", "jax")):
        prefix = str(tmp_path / f"{kind}_by_{maker}")
        if kind == "decoded":
            built = (cache if maker == "port" else jax_cache).DecodedImageCache.build(
                paths, prefix, verbose=False)
            mod = cache if opener == "port" else jax_cache
            opened = mod.DecodedImageCache.open(prefix)
            if opener == "port":
                reused = cache.DecodedImageCache.build(paths, prefix, reader=_refuse,
                                                       verbose=False)
                assert reused._index == built._index
            for p in paths:
                np.testing.assert_array_equal(opened.reader(p), built.reader(p))
            continue
        built = _resized(maker, paths, prefix, cfg)
        mod = cache if opener == "port" else jax_cache
        opened = mod.ResizedImageCache.open(prefix)
        if opener == "port":
            reused = _resized("port", paths, prefix, cfg, reader=_refuse)
            assert reused._index == built._index
        for p in paths:
            for t in TARGETS:
                a = opened.get(p, t, cfg.TRAIN.MAX_SIZE, cfg.DEVICE.BUCKETS)
                b = built.get(p, t, cfg.TRAIN.MAX_SIZE, cfg.DEVICE.BUCKETS)
                assert a[1] == b[1]
                np.testing.assert_array_equal(a[0], b[0])


def test_stale_caches_rebuild_and_a_changed_max_size_misses(roidb, tmp_path):
    cfg = cfg_from_list(default_config(), CFG)
    paths = _paths(roidb)
    reads = []

    def reader(path):
        reads.append(path)
        return loader.read_image(path)

    prefix = str(tmp_path / "resized")
    _resized("port", paths, prefix, cfg, reader)
    assert len(reads) == len(paths)
    _resized("port", paths, prefix, cfg, reader)            # current: reused
    assert len(reads) == len(paths)
    st = os.stat(paths[0])
    try:
        os.utime(paths[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))   # touched
        again = _resized("port", paths, prefix, cfg, reader)
        assert len(reads) == 2 * len(paths)                 # rebuilt
        assert again._index[(paths[0], 200)][6] == os.stat(paths[0]).st_mtime
    finally:
        os.utime(paths[0], ns=(st.st_atime_ns, st.st_mtime_ns))
    decoded_prefix = str(tmp_path / "decoded")
    cache.DecodedImageCache.build(paths, decoded_prefix, reader=reader, verbose=False)
    n = len(reads)
    cache.DecodedImageCache.build(paths, decoded_prefix, reader=reader, verbose=False)
    assert len(reads) == n                                   # current: reused

    # a MAX_SIZE of 150 (< the target 200) changes every scale: get refuses,
    # and the batch is the f32 route's, read by read_image
    capped = cfg_from_list(default_config(), CFG + ["TRAIN.MAX_SIZE", "150"])
    resized = cache.ResizedImageCache.open(prefix)
    assert resized.get(paths[0], 200, 150, capped.DEVICE.BUCKETS) is None
    entries = [roidb[0], roidb[len(roidb) // 2]]             # an image and a flipped one
    got = get_minibatch(entries, capped, np.random.RandomState(0), reader=resized)
    want = get_minibatch(entries, capped, np.random.RandomState(0))
    assert got["data"].dtype == np.float32
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _flipped_after_resize(entry, cfg, bucket_hw):
    """A flipped entry as the resized caches serve it: the unflipped image
    resized in f32 by the uncached route, then flipped, zero-padded."""
    im = loader.read_image(entry["image"])
    padded, scale = loader.prep_im_for_blob(im, cfg.TRAIN.SCALES[0], cfg.TRAIN.MAX_SIZE,
                                            cfg.DEVICE.BUCKETS)
    sh, sw = int(round(im.shape[0] * scale)), int(round(im.shape[1] * scale))
    row = np.zeros((*bucket_hw, 3), np.float32)
    row[:sh, :sw] = padded[:sh, :sw][:, ::-1]
    return row


def test_cached_batches_match_jax_and_the_f32_route(roidb, tmp_path):
    """Through the caches the port and JAX give the same batches within 1
    LSB.  Against the uncached f32 route each row is within 2.0, with one
    exception, JAX's as much as the port's: a cache flips the resized image,
    the f32 route resizes the flipped one, and the two sample the same
    source points only where round(w * scale) / scale == w.  Elsewhere the
    flipped view lies |round(w * scale) / scale - w| < 0.5 source pixels to
    the side (0.4 here: w 320 and 400 at scale 5/6), far beyond 2.0 on this
    devkit's per-pixel noise; those rows are within 2.0 of the uncached
    route's resize of the unflipped image, flipped."""
    cfg = cfg_from_list(default_config(), CFG)
    jcfg = jax_cfg_from_list(jax_default_config(), CFG)
    paths = _paths(roidb)
    ours = _resized("port", paths, str(tmp_path / "port"), cfg)
    theirs = _resized("jax", paths, str(tmp_path / "jax"), cfg)
    cached = RoIDataLayer(roidb, cfg, reader=ours)
    jax_cached = JaxRoIDataLayer(copy.deepcopy(roidb), jcfg, reader=theirs)
    plain = RoIDataLayer(roidb, cfg)
    shifted = 0
    for _ in range(4):
        inds = cached._perm[cached._cur:cached._cur + 2]
        a, b, c = cached.forward(), jax_cached.forward(), plain.forward()
        assert a["data"].dtype == b["data"].dtype == np.uint8 and c["data"].dtype == np.float32
        assert a["data"].shape == b["data"].shape == c["data"].shape
        assert np.abs(a["data"].astype(np.int16) - b["data"].astype(np.int16)).max() <= 1
        for key in ("im_info", "gt_boxes", "gt_labels", "gt_valid"):
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], c[key])
        for row, i in enumerate(inds):
            entry, scale = roidb[i], float(a["im_info"][row, 2])
            got = a["data"][row].astype(np.float32)
            exact = round(entry["width"] * scale) / scale == entry["width"]
            if entry["flipped"] and not exact:
                shifted += 1
                assert np.abs(got - c["data"][row]).max() > 2.0          # the shift shows
                want = _flipped_after_resize(entry, cfg, a["data"].shape[1:3])
                np.testing.assert_allclose(got, want, atol=2.0)
            else:
                np.testing.assert_allclose(got, c["data"][row], atol=2.0)
    assert shifted >= 1 and any(roidb[i]["flipped"] for i in cached._perm[:8])
