"""A synthetic COCO tree whose images are drawn in memory from a seed.

The COCO counterpart of :mod:`ssds_tpu_torch.tools.synth_voc`.
:func:`write_coco` writes ``{root}/annotations/instances_{split}2017.json``
with ``json`` (no image files), and :func:`in_memory_coco` gives a
:class:`~ssds_tpu_torch.data.coco.COCODetection` whose ``_read_image`` draws
each image again from ``(seed, image id)``. The data exercise what COCO asks
of the path:

- images of varied size, 240-640 wide and 240-480 high, so every image is
  resized to the model's input;
- COCO 2017's 80 category ids (1-90 without 12, 26, 29, 30, 45, 66, 68, 69,
  71, 83), so the id -> contiguous label remap is exercised;
- 1-8 objects an image, each a filled box in its category's colour on a dark
  noisy background;
- some ``iscrowd`` regions, some annotations without ``area``, some
  zero-width boxes and some images with no annotation.

Everything after the image read is the real COCO code path.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ssds_tpu_torch.data.coco import COCODetection

# COCO 2017's 80 categories, by id
COCO_CATEGORIES = (
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"), (5, "airplane"),
    (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"), (10, "traffic light"),
    (11, "fire hydrant"), (13, "stop sign"), (14, "parking meter"), (15, "bench"),
    (16, "bird"), (17, "cat"), (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"),
    (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"), (27, "backpack"),
    (28, "umbrella"), (31, "handbag"), (32, "tie"), (33, "suitcase"), (34, "frisbee"),
    (35, "skis"), (36, "snowboard"), (37, "sports ball"), (38, "kite"),
    (39, "baseball bat"), (40, "baseball glove"), (41, "skateboard"), (42, "surfboard"),
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"), (47, "cup"), (48, "fork"),
    (49, "knife"), (50, "spoon"), (51, "bowl"), (52, "banana"), (53, "apple"),
    (54, "sandwich"), (55, "orange"), (56, "broccoli"), (57, "carrot"), (58, "hot dog"),
    (59, "pizza"), (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"), (70, "toilet"), (72, "tv"),
    (73, "laptop"), (74, "mouse"), (75, "remote"), (76, "keyboard"), (77, "cell phone"),
    (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"), (82, "refrigerator"),
    (84, "book"), (85, "clock"), (86, "vase"), (87, "scissors"), (88, "teddy bear"),
    (89, "hair drier"), (90, "toothbrush"),
)
# one fill colour (BGR) per category, in the order above
CLASS_COLOURS = np.random.default_rng(80).integers(64, 256, (len(COCO_CATEGORIES), 3)).astype(
    np.uint8)


def sample(seed: int, image_id: int):
    """Image ``image_id``: ``(HWC uint8 BGR [h, w, 3], annotations)``, each
    annotation a dict of ``bbox`` ([x, y, w, h] pixels), ``category_id``,
    ``iscrowd`` and (mostly) ``area``, drawn boxes last on top."""
    rng = np.random.default_rng([seed, image_id])
    w, h = int(rng.integers(240, 641)), int(rng.integers(240, 481))
    img = rng.integers(0, 48, (h, w, 3), dtype=np.uint8)
    anns = []
    if image_id % 11 == 5:  # an image with no annotation
        return img, anns
    for k in range(int(rng.integers(1, 9))):
        ci = int(rng.integers(0, len(COCO_CATEGORIES)))
        bw, bh = (int(rng.integers(lo // 10, lo // 2)) for lo in (w, h))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        img[y:y + bh, x:x + bw] = CLASS_COLOURS[ci]
        ann = {"bbox": [float(x), float(y), float(bw), float(bh)],
               "category_id": COCO_CATEGORIES[ci][0],
               "iscrowd": int(k == 0 and image_id % 7 == 3)}
        if image_id % 5 != 2:  # else the eval falls back to the box's area
            ann["area"] = float(bw * bh) * 0.8  # a segmentation inside the box
        anns.append(ann)
    if image_id % 9 == 4:  # a zero-width box, which the dataset drops
        anns.append({"bbox": [10.0, 10.0, 0.0, 20.0], "category_id": COCO_CATEGORIES[0][0],
                     "iscrowd": 0, "area": 0.0})
    return img, anns


def write_coco(root: str, seed: int, n_train: int = 256, n_val: int = 128,
               year: str = "2017") -> None:
    """``{root}/annotations/instances_train{year}.json`` over image ids
    ``1 .. n_train`` and ``instances_val{year}.json`` over the next
    ``n_val``. No image files."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    categories = [{"id": cid, "name": name, "supercategory": ""}
                  for cid, name in COCO_CATEGORIES]
    aid = 1
    for split, ids in (("train", range(1, n_train + 1)),
                       ("val", range(n_train + 1, n_train + n_val + 1))):
        images, annotations = [], []
        for iid in ids:
            img, anns = sample(seed, iid)
            images.append({"id": iid, "file_name": f"{iid:012d}.jpg",
                           "height": img.shape[0], "width": img.shape[1]})
            for ann in anns:
                annotations.append(dict(ann, id=aid, image_id=iid))
                aid += 1
        with open(os.path.join(root, "annotations", f"instances_{split}{year}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)


def in_memory_coco(seed: int):
    """A :class:`COCODetection` subclass whose images come from :func:`sample`
    (to put in ``data.factory.dataset_map['coco']``)."""

    class InMemoryCOCO(COCODetection):
        def _read_image(self, img_id) -> np.ndarray:
            return sample(seed, int(img_id[1]))[0]

    return InMemoryCOCO
