"""Inference-only ObjectDetector (counterpart of :mod:`ssds_tpu.detector`).

Reference ``lib/ssds.py``: ``ObjectDetector.__init__`` = create_model +
load RESUME_CHECKPOINT + PriorBox + Detect; ``predict(img, threshold,
check_time)`` = preprocess one image -> forward -> Detect -> rescale boxes to
the original image -> score filter, with optional per-stage timing.

Everything after the host-side resize runs on ``device``: mean
subtraction, the conv forward (bf16 when ``MODEL.HALF_PRECISION``), then
softmax, decode and detect in float32, with the batched NMS as the CUDA
kernel on a GPU. A YOLO head has no priors: it decodes its own boxes
(normalised to the model's input size) and they go through
``detect_decoded``. The host uploads one ``[B, H, W, 3]`` uint8 batch and
downloads one ``[B, C, max_det, 5]`` float32 block. The device part is one
module, :class:`Predict`, which :mod:`ssds_tpu_torch.export` exports as is.

An image that is not at the model's input size is resized on the host by
:func:`ssds_tpu_torch.data.image_ops.resize_linear`, numpy bit-equal to the
bilinear resize the JAX detector calls, so serving needs no OpenCV.

``MODEL.QUANT: int8`` quantises the model at construction
(:meth:`ObjectDetector.quantize_int8`, :mod:`ssds_tpu_torch.quant`): its
convs then run as the int8 kernels of ``csrc/int8_conv.cu`` on the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ssds_tpu_torch import quant
from ssds_tpu_torch.checkpoint import load_state_dict_file
from ssds_tpu_torch.data.image_ops import resize_linear
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model, is_yolo
from ssds_tpu_torch.ops.postprocess import PostProcessConfig, detect, detect_decoded


def _resize(img: np.ndarray, hw) -> np.ndarray:
    """HWC uint8 to the model size (bilinear, as the JAX detector's)."""
    if img.shape[:2] == tuple(hw):
        return img
    return resize_linear(img, hw)


class Predict(torch.nn.Module):
    """The pure predict function that :class:`ObjectDetector` serves and
    :mod:`ssds_tpu_torch.export` exports: uint8 BGR ``[B, H, W, 3]`` at the
    model's size -> dense ``[B, C, max_det, 5]`` float32 rows, through the
    mean subtraction, the NHWC -> NCHW permute, the forward in ``dtype``,
    and ``detect`` against ``priors`` (``detect_decoded`` when ``priors`` is
    None: a YOLO head). The means and priors are buffers, so an exported
    program carries them."""

    def __init__(self, model: torch.nn.Module, means: torch.Tensor, priors, post,
                 dtype: torch.dtype):
        super().__init__()
        self.model, self.post, self.dtype = model, post, dtype
        self.register_buffer("means", means)
        self.register_buffer("priors", priors)

    def raw(self, img_u8: torch.Tensor, phase: str = "eval"):
        """The model's outputs: eval-phase ``(loc, conf)`` float32, a YOLO
        head's ``(boxes, scores)``, or ``phase="train"``'s raw outputs."""
        x = (img_u8.float() - self.means).permute(0, 3, 1, 2).contiguous()
        return self.model(x.to(self.dtype), phase=phase)

    def detect(self, out) -> torch.Tensor:
        """:meth:`raw`'s eval outputs -> the dense rows."""
        if self.priors is None:
            return detect_decoded(*out, self.post)
        return detect(*out, self.priors, self.post)

    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        return self.detect(self.raw(img_u8))


class ObjectDetector:
    """Serve one model config on one device.

    Args:
      cfg: the full config tree (``MODEL``, ``POST_PROCESS``, ``DATASET``,
        ``RESUME_CHECKPOINT``).
      device: where the model runs. ``"cuda"`` raises when no GPU exists.
      seed: seeds the random init used when ``RESUME_CHECKPOINT`` is empty.

    ``RESUME_CHECKPOINT`` names a ``.pth`` state dict in the port's
    (reference torch) layout: a checkpoint of
    :mod:`ssds_tpu_torch.checkpoint`, or one written from JAX parameters by
    :func:`ssds_tpu_torch.weights.state_dict_from_jax`.
    """

    def __init__(self, cfg, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ObjectDetector: device 'cuda' asked for, but no GPU is available")
        model_cfg = cfg.MODEL
        model, self.feature_maps = create_model(model_cfg)
        self.img_hw = (int(model_cfg.IMAGE_SIZE[0]), int(model_cfg.IMAGE_SIZE[1]))
        self.dtype = torch.bfloat16 if bool(model_cfg.HALF_PRECISION) else torch.float32
        self.model = init_model(model, seed=seed, device="cpu")
        if cfg.RESUME_CHECKPOINT:
            self.model.load_state_dict(load_state_dict_file(cfg.RESUME_CHECKPOINT), strict=True)
        # the float32 conv weights and biases, which int8 quantisation reads
        # (JAX quantises its float32 parameters), kept on the host where the
        # model will hold them in another dtype
        self._float_convs = {} if self.dtype == torch.float32 else {
            name: (m.weight.detach(), None if m.bias is None else m.bias.detach())
            for name, m in self.model.named_modules() if isinstance(m, torch.nn.Conv2d)}
        self.model.to(self.device)
        # flax casts conv params to the compute dtype per call; cast once here.
        # L2Norm keeps its float32 scale (it computes in float32). So does
        # BatchNorm: flax's nn.BatchNorm(dtype=x.dtype) subtracts its float32
        # running mean from the bf16 input, which promotes to float32,
        # normalises in float32 and rounds the result to bf16 once
        # (ssds_tpu/models/layers.py:597-599); F.batch_norm on a bf16 input
        # with float32 statistics does the same. A head's FLOAT32_MODULES
        # (FSSD's pyramid and predictors) compute in float32 in both packages.
        keep = {id(m) for name in getattr(self.model, "FLOAT32_MODULES", ())
                for m in self.model.get_submodule(name).modules()}
        for m in self.model.modules():
            if isinstance(m, torch.nn.Conv2d) and id(m) not in keep:
                m.to(self.dtype)
        self.priors = None if is_yolo(model_cfg) else torch.from_numpy(
            create_priors(model_cfg, self.feature_maps)).to(self.device)
        self.means = torch.tensor(cfg.DATASET.PIXEL_MEANS, dtype=torch.float32,
                                  device=self.device)
        self.post = PostProcessConfig.from_cfg(cfg.POST_PROCESS)
        self.predictor = Predict(self.model, self.means, self.priors, self.post, self.dtype)
        if str(model_cfg.get("QUANT", "")) == "int8":
            self.quantize_int8()

    def quantize_int8(self, calib_images=None, skip_re=None) -> int:
        """Post-training int8 quantisation of the serving path, in place
        (``ssds_tpu/detector.py:116-153``): calibrate each conv's activation
        scale on a few forwards in the detector's dtype, quantise the float32
        weights per output channel, and swap the convs for
        :class:`ssds_tpu_torch.quant.QuantConv2d`.

        calib_images: ``[B, H, W, 3]`` uint8 batches at the model's size;
        None gives JAX's four seeded random images. skip_re: a regex over
        the port's module names (``"loc|conf"``); matching convs stay float.
        Returns the number of int8 convs."""
        h, w = self.img_hw
        if calib_images is None:
            rng = np.random.default_rng(0)
            calib_images = [rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8) for _ in range(4)]
        self.model.eval()
        amax = quant.collect_absmax(self.model, calib_images, lambda b: self.forward(
            torch.from_numpy(np.ascontiguousarray(b)).to(self.device)))
        quant.quantize_model(self.model, amax, skip_re, self._float_convs)
        return quant.num_quantized(self.model)

    @torch.no_grad()
    def forward(self, img_u8: torch.Tensor, phase: str = "eval"):
        """``[B, H, W, 3]`` uint8 BGR at model size, on ``device`` ->
        eval-phase ``(loc [B,K,4], conf [B,K,C])`` float32; for a YOLO head
        ``(boxes [B,K,4], scores [B,K,C])``. ``phase="train"`` gives the raw
        outputs instead (the model stays in eval mode)."""
        return self.predictor.raw(img_u8, phase)

    def postprocess(self, out) -> torch.Tensor:
        """:meth:`forward`'s outputs -> dense ``[B, C, max_det, 5]`` rows:
        ``detect`` against the priors, or ``detect_decoded`` for a YOLO head."""
        return self.predictor.detect(out)

    @torch.no_grad()
    def detect_rows(self, batch_u8: np.ndarray) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 at model size -> dense ``[B, C, max_det, 5]``
        detections on ``device`` (not synchronised): :class:`Predict`."""
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        return self.predictor(x)

    def predict_batch(self, imgs, threshold: float = 0.6):
        """Batched :meth:`predict`: images of any sizes are resized on the
        host, stacked and served as one batch (batch >= 4 takes the pruned
        detect path, see ``PostProcessConfig.pre_nms_top_n``); each image's
        detections are rescaled to its own original size.

        Returns a list of ``(boxes_px [N,4], labels [N], scores [N])``, one
        per image, rows in descending score.
        """
        x = np.stack([_resize(img, self.img_hw) for img in imgs]).astype(np.uint8)
        dets = self.detect_rows(x).cpu().numpy()
        results = []
        for img, rows in zip(imgs, dets):
            orig_h, orig_w = img.shape[:2]
            scale = np.array([orig_w, orig_h, orig_w, orig_h], np.float32)
            cls, slot = np.nonzero(rows[..., 0] > threshold)
            picked = rows[cls, slot]
            order = np.argsort(-picked[:, 0], kind="stable")
            results.append((
                picked[order, 1:5] * scale,
                (cls[order] - 1).astype(np.int32),  # drop the background offset
                picked[order, 0].astype(np.float32),
            ))
        return results

    def predict(self, img: np.ndarray, threshold: float = 0.6, check_time: bool = False):
        """img: HWC BGR uint8 (any size). Returns ``(boxes_px [N,4], labels
        [N], scores [N])`` above threshold, class-major; with check_time also
        a dict of per-stage seconds (preprocess / forward_detect /
        postfilter / total), the device stage closed by a synchronise."""
        t_all = time.perf_counter()
        orig_h, orig_w = img.shape[:2]
        t0 = time.perf_counter()
        x = _resize(img, self.img_hw)[None].astype(np.uint8)
        t_pre = time.perf_counter() - t0

        t0 = time.perf_counter()
        dets = self.detect_rows(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dets = dets[0].cpu().numpy()
        t_fwd = time.perf_counter() - t0

        t0 = time.perf_counter()
        scale = np.array([orig_w, orig_h, orig_w, orig_h], np.float32)
        cls, slot = np.nonzero(dets[..., 0] > threshold)  # class-major, slot order
        picked = dets[cls, slot]
        boxes = (picked[:, 1:5] * scale).reshape(-1, 4)
        labels = (cls - 1).astype(np.int32)
        scores = picked[:, 0].astype(np.float32)
        t_post = time.perf_counter() - t0
        total = time.perf_counter() - t_all
        if check_time:
            return (boxes, labels, scores), {
                "preprocess": t_pre, "forward_detect": t_fwd,
                "postfilter": t_post, "total": total,
            }
        return boxes, labels, scores
