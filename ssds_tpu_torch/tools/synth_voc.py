"""A synthetic VOC tree whose images are drawn in memory from a seed.

The training path reads VOC: XML annotations, ``ImageSets`` lists and JPEG
images. A machine without OpenCV cannot decode a JPEG, so
:func:`write_voc` writes the annotations and lists only (``xml.etree``),
and :func:`in_memory_voc` gives a :class:`~ssds_tpu_torch.data.voc.VOCDetection`
whose ``_read_image`` draws each image again from ``(seed, index)``: a dark
noisy background with 1-3 filled boxes, each box's colour that of its class.
Everything after the image read is the real VOC code path.

    python -m ssds_tpu_torch.tools.synth_voc --seed S --size N {train,test} --cfg CFG [...]

runs the port's train or test CLI (``ssds_tpu_torch.train`` / ``.test``,
the arguments after the command passed on) with ``dataset_map['voc']`` set
to :func:`in_memory_voc`, over a tree that :func:`write_voc` wrote with the
same seed and size; under ``torch.distributed.run`` each rank does so.
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

import numpy as np

from ssds_tpu_torch.data.voc import VOC_CLASSES, VOCDetection

# one fill colour (BGR) per VOC class
CLASS_COLOURS = np.random.default_rng(20).integers(64, 256, (len(VOC_CLASSES), 3)).astype(np.uint8)


def sample(seed: int, index: int, size: int = 300):
    """Image ``index``: ``(HWC uint8 BGR [size, size, 3], [(class, xmin, ymin,
    xmax, ymax), ...])`` in VOC's 1-based inclusive pixel coordinates."""
    rng = np.random.default_rng([seed, index])
    img = rng.integers(0, 48, (size, size, 3), dtype=np.uint8)
    objects = []
    for _ in range(int(rng.integers(1, 4))):
        cls = int(rng.integers(0, len(VOC_CLASSES)))
        w, h = (int(v) for v in rng.integers(size // 8, size // 2, 2))
        x1, y1 = int(rng.integers(0, size - w)), int(rng.integers(0, size - h))
        img[y1:y1 + h, x1:x1 + w] = CLASS_COLOURS[cls]
        objects.append((VOC_CLASSES[cls], x1 + 1, y1 + 1, x1 + w, y1 + h))
    return img, objects


def write_voc(root: str, seed: int, n_trainval: int = 64, n_test: int = 32, size: int = 300,
              year: str = "2007", draw=sample) -> None:
    """``{root}/VOC{year}``: an annotation for every image, ``trainval.txt``
    listing images ``0 .. n_trainval - 1`` and ``test.txt`` the next
    ``n_test`` (with ``n_test = 0``, the same images as ``trainval.txt``: an
    overfit set). No image files. ``draw(seed, index, size)`` gives an image
    and its objects, as :func:`sample` does."""
    voc = os.path.join(root, "VOC" + year)
    os.makedirs(os.path.join(voc, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(voc, "ImageSets", "Main"), exist_ok=True)
    for i in range(n_trainval + n_test):
        _, objects = draw(seed, i, size)
        ann = ET.Element("annotation")
        sz = ET.SubElement(ann, "size")
        ET.SubElement(sz, "width").text = str(size)
        ET.SubElement(sz, "height").text = str(size)
        for name, *box in objects:
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = "0"
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bb, tag).text = str(v)
        ET.ElementTree(ann).write(os.path.join(voc, "Annotations", f"{i:06d}.xml"))
    test = range(n_trainval, n_trainval + n_test) if n_test else range(n_trainval)
    for split, ids in (("trainval", range(n_trainval)), ("test", test)):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("".join(f"{i:06d}\n" for i in ids))


def in_memory_voc(seed: int, size: int = 300, draw=sample):
    """A :class:`VOCDetection` subclass whose images come from ``draw``
    (:func:`sample`; to put in ``data.factory.dataset_map['voc']``)."""

    class InMemoryVOC(VOCDetection):
        def _read_image(self, img_id) -> np.ndarray:
            return draw(seed, int(img_id[1]), size)[0]

    return InMemoryVOC


def main(argv=None):
    parser = argparse.ArgumentParser(description="the train or test CLI over a synthetic VOC "
                                                 "tree whose images are drawn in memory")
    parser.add_argument("--seed", type=int, required=True, help="write_voc's seed")
    parser.add_argument("--size", type=int, default=300, help="write_voc's image size")
    parser.add_argument("cli", choices=["train", "test"])
    args, rest = parser.parse_known_args(argv)
    from ssds_tpu_torch import test, train
    from ssds_tpu_torch.data import factory

    factory.dataset_map["voc"] = in_memory_voc(args.seed, args.size)
    (train.train if args.cli == "train" else test.test)(rest)


if __name__ == "__main__":
    main()
