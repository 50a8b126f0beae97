"""PASCAL VOC detection dataset and the PASCAL evaluation protocol.

Counterpart of :mod:`ssds_tpu.data.voc` (reference ``lib/dataset/voc.py``):
``VOCDetection(root, image_sets, preproc, target_transform)`` parses the XML
annotations with ``AnnotationTransform`` and reads BGR images;
``evaluate_detections(all_boxes, output_dir)`` writes per-class
``det_test_*.txt`` files and runs the PASCAL ``voc_eval`` over them.

Every image read goes through :meth:`VOCDetection._read_image` (``cv2``
imported there), so a subclass can supply images without JPEG files or
OpenCV.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ssds_tpu_torch.data.voc_eval import voc_eval

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class AnnotationTransform:
    """VOC xml annotation -> ``[[x1, y1, x2, y2, label], ...]`` pixel coords,
    labels 0-based (background not included), difficult objects kept unless
    ``keep_difficult`` is False."""

    def __init__(self, class_to_ind=None, keep_difficult=True):
        self.class_to_ind = class_to_ind or dict(zip(VOC_CLASSES, range(len(VOC_CLASSES))))
        self.keep_difficult = keep_difficult

    def __call__(self, target):
        res = np.empty((0, 5), dtype=np.float32)
        for obj in target.iter("object"):
            difficult_el = obj.find("difficult")
            difficult = int(difficult_el.text) == 1 if difficult_el is not None else False
            if not self.keep_difficult and difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bbox = obj.find("bndbox")
            bndbox = [int(float(bbox.find(pt).text)) - 1
                      for pt in ("xmin", "ymin", "xmax", "ymax")]
            bndbox.append(self.class_to_ind[name])
            res = np.vstack((res, np.asarray(bndbox, np.float32)))
        return res


class VOCDetection:
    """VOC dataset: index -> ``(preprocessed image, targets, original (h, w))``.

    The directory layout is ``{root}/VOC{year}/{Annotations,JPEGImages,
    ImageSets/Main}``, as the reference's.
    """

    def __init__(self, root, image_sets, preproc=None, target_transform=None,
                 dataset_name="VOC0712"):
        self.root = root
        self.image_set = image_sets
        self.preproc = preproc
        self.target_transform = target_transform or AnnotationTransform()
        self.name = dataset_name
        self._annopath = os.path.join("%s", "Annotations", "%s.xml")
        self._imgpath = os.path.join("%s", "JPEGImages", "%s.jpg")
        self.ids = []
        for year, name in image_sets:
            rootpath = os.path.join(self.root, "VOC" + year)
            listfile = os.path.join(rootpath, "ImageSets", "Main", name + ".txt")
            with open(listfile) as f:
                for line in f:
                    self.ids.append((rootpath, line.strip()))
        self.num_classes = len(VOC_CLASSES)
        self.classes = VOC_CLASSES

    def __len__(self):
        return len(self.ids)

    def _read_image(self, img_id) -> np.ndarray:
        """HWC BGR uint8 image of ``img_id = (rootpath, name)``."""
        import cv2

        path = self._imgpath % img_id
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        return img

    def __getitem__(self, index):
        img_id = self.ids[index]
        target = ET.parse(self._annopath % img_id).getroot()
        img = self._read_image(img_id)
        orig_hw = img.shape[:2]
        target = self.target_transform(target)
        if self.preproc is not None:
            img, target = self.preproc(img, target)
        return img, target, orig_hw

    def pull_image(self, index):
        return self._read_image(self.ids[index])

    def pull_anno(self, index):
        img_id = self.ids[index]
        anno = ET.parse(self._annopath % img_id).getroot()
        return img_id[1], self.target_transform(anno)

    # -- evaluation (reference voc.py evaluate_detections) --------------------

    def evaluate_detections(self, all_boxes, output_dir):
        """``all_boxes[class][image] = [[x1, y1, x2, y2, score], ...]`` in pixels.

        Writes per-class detection files then runs the PASCAL eval; returns mAP.
        """
        os.makedirs(output_dir, exist_ok=True)
        self._write_voc_results_file(all_boxes, output_dir)
        aps = self._do_python_eval(output_dir)
        return float(np.mean(aps)) if len(aps) else 0.0

    def _get_voc_results_file_template(self, output_dir):
        filedir = os.path.join(output_dir, "results")
        os.makedirs(filedir, exist_ok=True)
        return os.path.join(filedir, "det_test_{:s}.txt")

    def _write_voc_results_file(self, all_boxes, output_dir):
        template = self._get_voc_results_file_template(output_dir)
        for cls_ind, cls in enumerate(VOC_CLASSES):
            with open(template.format(cls), "w") as f:
                for im_ind, index in enumerate(self.ids):
                    dets = all_boxes[cls_ind + 1][im_ind]
                    if dets is None or len(dets) == 0:
                        continue
                    dets = np.asarray(dets)
                    for k in range(dets.shape[0]):
                        # the devkit expects 1-based pixel coordinates
                        f.write("{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n".format(
                            index[1], dets[k, 4], dets[k, 0] + 1, dets[k, 1] + 1,
                            dets[k, 2] + 1, dets[k, 3] + 1))

    def _do_python_eval(self, output_dir):
        # eval against the FIRST image set (the reference evaluates the test set)
        year, name = self.image_set[0]
        rootpath = os.path.join(self.root, "VOC" + year)
        annopath = os.path.join(rootpath, "Annotations", "{:s}.xml")
        imagesetfile = os.path.join(rootpath, "ImageSets", "Main", name + ".txt")
        cachedir = os.path.join(output_dir, "annotations_cache")
        use_07_metric = int(year) < 2010
        template = self._get_voc_results_file_template(output_dir)
        aps = []
        for cls in VOC_CLASSES:
            _, _, ap = voc_eval(template, annopath, imagesetfile, cls, cachedir,
                                ovthresh=0.5, use_07_metric=use_07_metric)
            if ap >= 0:
                aps.append(ap)
            print(f"AP for {cls} = {ap:.4f}")
        mAP = np.mean(aps) if aps else 0.0
        print(f"Mean AP = {mAP:.4f}")
        return aps
