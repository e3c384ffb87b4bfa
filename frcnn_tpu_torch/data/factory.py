"""Dataset factory (``frcnn_tpu/data/factory.py``): name → imdb for the VOC
and COCO splits, the same names as the JAX package."""

from __future__ import annotations


def _sets():
    from frcnn_tpu_torch.data.coco import coco
    from frcnn_tpu_torch.data.pascal_voc import pascal_voc

    sets = {}
    for year in ("2007", "2012"):
        for split in ("train", "val", "trainval", "test"):
            name = f"voc_{year}_{split}"
            sets[name] = lambda dd, split=split, year=year: pascal_voc(split, year, data_dir=dd)
            sets[name + "_diff"] = (lambda dd, split=split, year=year:
                                    pascal_voc(split, year, use_diff=True, data_dir=dd))
    for year, splits in (("2014", ("train", "val", "minival", "valminusminival")),
                         ("2015", ("test", "test-dev"))):
        for split in splits:
            sets[f"coco_{year}_{split}"] = (lambda dd, split=split, year=year:
                                            coco(split, year, data_dir=dd))
    return sets


def get_imdb(name: str, data_dir: str | None = None):
    """The imdb called ``name``, its files under ``data_dir`` (default: the
    module config's DATA_DIR); a KeyError lists the known names."""
    sets = _sets()
    if name not in sets:
        raise KeyError(f"unknown dataset: {name}; known: {sorted(sets)}")
    return sets[name](data_dir)


def list_imdbs():
    return sorted(_sets())
