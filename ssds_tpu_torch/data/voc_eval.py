"""PASCAL VOC detection evaluation (AP per class, 07 metric or AUC).

A copy of :mod:`ssds_tpu.data.voc_eval` (reference
``lib/dataset/voc_eval.py``): ``parse_rec`` (XML annotation parse),
``voc_ap`` (11-point 2007 metric or the area under the monotone PR curve),
``voc_eval`` (per-class precision/recall from a detection file and a cached
pickle of the parsed annotations). numpy and the standard library only.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(filename):
    """Parse a PASCAL VOC xml annotation file into a list of object dicts."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        obj_struct = {}
        obj_struct["name"] = obj.find("name").text
        pose = obj.find("pose")
        obj_struct["pose"] = pose.text if pose is not None else ""
        truncated = obj.find("truncated")
        obj_struct["truncated"] = int(truncated.text) if truncated is not None else 0
        difficult = obj.find("difficult")
        obj_struct["difficult"] = int(difficult.text) if difficult is not None else 0
        bbox = obj.find("bndbox")
        obj_struct["bbox"] = [
            int(float(bbox.find("xmin").text)),
            int(float(bbox.find("ymin").text)),
            int(float(bbox.find("xmax").text)),
            int(float(bbox.find("ymax").text)),
        ]
        objects.append(obj_struct)
    return objects


def voc_ap(rec, prec, use_07_metric=True):
    """AP given precision/recall. 07 metric: mean precision at 11 recall
    points; else: area under the monotone-envelope PR curve."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            if np.sum(rec >= t) == 0:
                p = 0.0
            else:
                p = np.max(prec[rec >= t])
            ap = ap + p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir, ovthresh=0.5,
             use_07_metric=True):
    """Per-class PASCAL VOC evaluation.

    Args:
      detpath: detection file path template, ``detpath.format(classname)``;
        each line: ``image_id score x1 y1 x2 y2`` (1-based pixel coords).
      annopath: annotation xml template, ``annopath.format(image_id)``.
      imagesetfile: text file with one image id per line.
      classname: category name.
      cachedir: directory for the parsed-annotation pickle cache.

    Returns:
      (recall array, precision array, ap scalar); ap is -1 when the class has
      no detection file or an empty one.
    """
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f.readlines()]

    if not os.path.isfile(cachefile):
        recs = {}
        for imagename in imagenames:
            recs[imagename] = parse_rec(annopath.format(imagename))
        with open(cachefile, "wb") as f:
            pickle.dump(recs, f)
    else:
        with open(cachefile, "rb") as f:  # written by this function above
            recs = pickle.load(f)

    # ground truth for this class
    class_recs = {}
    npos = 0
    for imagename in imagenames:
        r = [obj for obj in recs[imagename] if obj["name"] == classname]
        bbox = np.array([x["bbox"] for x in r])
        difficult = np.array([x["difficult"] for x in r]).astype(bool)
        det = [False] * len(r)
        npos = npos + sum(~difficult)
        class_recs[imagename] = {"bbox": bbox, "difficult": difficult, "det": det}

    detfile = detpath.format(classname)
    if not os.path.exists(detfile):
        return np.array([]), np.array([]), -1.0
    with open(detfile) as f:
        lines = f.readlines()
    if not lines:
        return np.array([]), np.array([]), -1.0

    splitlines = [x.strip().split(" ") for x in lines]
    image_ids = [x[0] for x in splitlines]
    confidence = np.array([float(x[1]) for x in splitlines])
    BB = np.array([[float(z) for z in x[2:]] for x in splitlines])

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, :]
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d, :].astype(float)
        ovmax = -np.inf
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            ixmin = np.maximum(BBGT[:, 0], bb[0])
            iymin = np.maximum(BBGT[:, 1], bb[1])
            ixmax = np.minimum(BBGT[:, 2], bb[2])
            iymax = np.minimum(BBGT[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (BBGT[:, 2] - BBGT[:, 0] + 1.0) * (BBGT[:, 3] - BBGT[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = np.argmax(overlaps)
        if ovmax > ovthresh:
            if not R["difficult"][jmax]:
                if not R["det"][jmax]:
                    tp[d] = 1.0
                    R["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap
