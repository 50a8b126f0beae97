"""COCO detection dataset and the COCOeval bbox protocol (no pycocotools).

Counterpart of :mod:`ssds_tpu.data.coco` (reference ``lib/dataset/coco.py``):
``COCODetection(root, image_sets, preproc)`` reads
``{root}/annotations/instances_{split}{year}.json`` with ``json``, remaps the
category ids to contiguous labels, drops zero-size boxes, keeps ``iscrowd``
annotations out of the training targets but as ignore regions for the eval,
and takes each annotation's ``area`` (its bbox area when absent) for the
eval's area ranges. ``evaluate_detections(all_boxes, output_dir)`` writes
``detections_results.json`` in COCO's result format, prints the 12-line
summary of :mod:`ssds_tpu_torch.data.coco_eval` and returns AP@[.50:.95].

Every image read goes through :meth:`COCODetection._read_image` (``cv2``
imported there), so a subclass can supply images without JPEG files or
OpenCV.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from ssds_tpu_torch.data import coco_eval


class COCODetection:
    """COCO dataset: index -> ``(preprocessed image, targets, original (h, w))``."""

    def __init__(self, root, image_sets, preproc=None, target_transform=None,
                 dataset_name="COCO"):
        self.root = root
        self.image_set = image_sets
        self.preproc = preproc
        self.name = dataset_name
        self.ids = []           # (img_path, image_id)
        self.annotations = {}   # image_id -> [N, 5] (x1, y1, x2, y2, label)
        self.img_info = {}      # image_id -> (height, width)
        # the eval's ignore regions and areas: crowds per image, and the
        # areas of the non-crowd rows (parallel to self.annotations)
        self.crowds = {}        # image_id -> [N, 5]
        self.crowd_areas = {}   # image_id -> [N]
        self.gt_areas = {}      # image_id -> [N]

        cat_ids = None
        for year, split in image_sets:
            ann_file = os.path.join(root, "annotations", f"instances_{split}{year}.json")
            img_dir = os.path.join(root, f"{split}{year}")
            with open(ann_file) as f:
                data = json.load(f)
            if cat_ids is None:
                cat_ids = sorted(c["id"] for c in data["categories"])
                self.cat_ids = cat_ids
                self.cat_to_contiguous = {c: i for i, c in enumerate(cat_ids)}
                self.contiguous_to_cat = {i: c for c, i in self.cat_to_contiguous.items()}
                self.classes = tuple(
                    c["name"] for c in sorted(data["categories"], key=lambda c: c["id"]))
            anns_by_img = defaultdict(list)
            areas_by_img = defaultdict(list)
            crowds_by_img = defaultdict(list)
            crowd_areas_by_img = defaultdict(list)
            for a in data["annotations"]:
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                row = [x, y, x + w, y + h, self.cat_to_contiguous[a["category_id"]]]
                area = float(a.get("area", w * h))
                if a.get("iscrowd", 0):
                    crowds_by_img[a["image_id"]].append(row)
                    crowd_areas_by_img[a["image_id"]].append(area)
                else:
                    anns_by_img[a["image_id"]].append(row)
                    areas_by_img[a["image_id"]].append(area)
            for img in data["images"]:
                iid = img["id"]
                self.ids.append((os.path.join(img_dir, img["file_name"]), iid))
                self.img_info[iid] = (img["height"], img["width"])
                self.annotations[iid] = np.asarray(
                    anns_by_img.get(iid, np.zeros((0, 5))), np.float32).reshape(-1, 5)
                self.gt_areas[iid] = np.asarray(areas_by_img.get(iid, np.zeros(0)), np.float32)
                self.crowds[iid] = np.asarray(
                    crowds_by_img.get(iid, np.zeros((0, 5))), np.float32).reshape(-1, 5)
                self.crowd_areas[iid] = np.asarray(
                    crowd_areas_by_img.get(iid, np.zeros(0)), np.float32)
        self.num_classes = len(self.cat_ids)

    def __len__(self):
        return len(self.ids)

    @staticmethod
    def _read_image(img_id) -> np.ndarray:
        """HWC BGR uint8 image of ``img_id = (path, image_id)`` (a subclass
        may override it with a method)."""
        import cv2

        img = cv2.imread(img_id[0], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {img_id[0]}")
        return img

    def __getitem__(self, index):
        img_id = self.ids[index]
        img = self._read_image(img_id)
        orig_hw = img.shape[:2]
        target = self.annotations[img_id[1]]
        if self.preproc is not None:
            img, target = self.preproc(img, target)
        return img, target, orig_hw

    def pull_image(self, index):
        return self._read_image(self.ids[index])

    def pull_anno(self, index):
        _, iid = self.ids[index]
        return iid, self.annotations[iid]

    def pull_img_anno(self, index):
        img_id = self.ids[index]
        h, w = self.img_info[img_id[1]]
        return self._read_image(img_id), self.annotations[img_id[1]], h, w

    # -- evaluation -------------------------------------------------------------

    def evaluate_detections(self, all_boxes, output_dir):
        """``all_boxes[class][image] = [[x1, y1, x2, y2, score], ...]`` in
        pixels, class 0 the background. Writes ``detections_results.json``,
        prints the 12-metric summary and returns AP (IoU .50:.95, area all,
        100 detections an image)."""
        os.makedirs(output_dir, exist_ok=True)

        gt_by_img_cat = {}
        for _, iid in self.ids:
            ann, areas = self.annotations[iid], self.gt_areas[iid]
            crowd, crowd_areas = self.crowds[iid], self.crowd_areas[iid]
            for c in range(self.num_classes):
                g = ann[:, 4] == c
                k = crowd[:, 4] == c
                if not g.any() and not k.any():
                    continue
                boxes = np.concatenate([ann[g][:, :4], crowd[k][:, :4]])
                iscrowd = np.concatenate(
                    [np.zeros(int(g.sum()), bool), np.ones(int(k.sum()), bool)])
                area = np.concatenate([areas[g], crowd_areas[k]])
                gt_by_img_cat[(iid, c)] = (boxes, iscrowd, area)

        dt_by_img_cat = {}
        results_json = []
        for c in range(self.num_classes):
            for im_ind, (_, iid) in enumerate(self.ids):
                d = all_boxes[c + 1][im_ind]
                if d is None or len(d) == 0:
                    continue
                d = np.asarray(d, np.float64).reshape(-1, 5)
                dt_by_img_cat[(iid, c)] = d
                cat = int(self.contiguous_to_cat[c])
                # the JAX module's per-row float(...) values, converted a column at a time
                for x, y, w, h, score in zip(d[:, 0].tolist(), d[:, 1].tolist(),
                                             (d[:, 2] - d[:, 0]).tolist(),
                                             (d[:, 3] - d[:, 1]).tolist(), d[:, 4].tolist()):
                    results_json.append({"image_id": int(iid), "category_id": cat,
                                         "bbox": [x, y, w, h], "score": score})
        with open(os.path.join(output_dir, "detections_results.json"), "w") as f:
            f.write(json.dumps(results_json))  # json.dump's bytes, from the C encoder

        stats = coco_eval.evaluate(gt_by_img_cat, dt_by_img_cat,
                                   img_ids=[iid for _, iid in self.ids],
                                   cat_ids=list(range(self.num_classes)))
        for line in stats.summary_lines():
            print(line)
        self.last_stats = stats
        return float(stats["AP"])
