"""Inference: the detect graph and the `Predictor` entry points.

Port of `postprocess_outputs`, `detect_batch`, `undo_letterbox_pixels`
and `Predictor` (`__init__`, `detect_preprocessed`, `detect_image`,
`get_fps`) of `jabd_tpu/predict.py`. One batch runs on the device as
forward -> top-k of the scores -> decode -> greedy NMS (the CUDA kernel
on the card) -> compaction to fixed [B, max_detections, 15] rows plus a
valid mask; the host letterboxes before and scales to pixels after.

Detection row layout: [x1, y1, x2, y2, score, 10 landmark coords].
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from jabd_tpu_torch import configs, resolve_device
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.models.retinaface import DTYPES
from jabd_tpu_torch.ops import anchors as A
from jabd_tpu_torch.ops import boxes as B
from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.ops import nms as N
from jabd_tpu_torch.ops import nms_cuda


def select_candidates(
    loc: torch.Tensor,  # [B, P, 4]
    cls: torch.Tensor,  # [B, P, 2]
    landm: torch.Tensor,  # [B, P, 10]
    anchors: torch.Tensor,  # [P, 4]
    pcfg: configs.PredictConfig,
    variances: Tuple[float, float] = (0.1, 0.2),
):
    """The k = min(pre_nms_topk, P) best scores per image, in descending
    order, and their decoded boxes and landmarks. Scores below the
    confidence are invalid. Among equal scores the lower anchor index
    comes first, as with `jax.lax.top_k` (a stable sort; `torch.topk`
    leaves the tie order open). Returns (boxes [B,k,4], scores [B,k],
    valid [B,k], landms [B,k,10])."""
    scores = cls[..., 1]
    k = min(pcfg.pre_nms_topk, scores.shape[-1])
    neg = torch.full((), N.NEG_INF, dtype=scores.dtype, device=scores.device)
    masked = torch.where(scores >= pcfg.confidence, scores, neg)
    top_sc, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_sc, idx = top_sc[:, :k], idx[:, :k]
    valid = top_sc > N.NEG_INF / 2
    cand_anchors = anchors[idx]  # [B, k, 4]

    def take(t):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    boxes = B.decode(take(loc), cand_anchors, variances)
    landms = B.decode_landm(take(landm), cand_anchors, variances)
    return boxes, top_sc, valid, landms


def postprocess_outputs(
    loc: torch.Tensor,
    cls: torch.Tensor,
    landm: torch.Tensor,
    anchors: torch.Tensor,
    pcfg: configs.PredictConfig,
    variances: Tuple[float, float] = (0.1, 0.2),
    keep_fn: Callable = nms_cuda.nms_keep_sorted,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head outputs -> (dets [B, max_out, 15], valid [B, max_out]) in
    normalized input coordinates. `keep_fn` computes the NMS keep masks:
    the kernel wrapper, or the plain version to check it."""
    boxes, scores, valid, landms = select_candidates(
        loc, cls, landm, anchors, pcfg, variances
    )
    keep = keep_fn(boxes, valid, pcfg.nms_iou, kind=pcfg.nms_kind)
    rows = torch.cat([boxes, scores[..., None], landms], dim=-1)  # [B, k, 15]
    return N.compact_keep(keep, rows, pcfg.max_detections)


def detect_batch(
    model: torch.nn.Module,
    images: torch.Tensor,  # [B, 3, H, W] float32, mean-subtracted
    anchors: torch.Tensor,
    pcfg: configs.PredictConfig,
    variances: Tuple[float, float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward + postprocess of one batch."""
    loc, cls, landm = model(images)
    return postprocess_outputs(loc, cls, landm, anchors, pcfg, variances)


def undo_letterbox_pixels(
    dets: np.ndarray,
    input_hw: Tuple[int, int],
    image_hw: Tuple[int, int],
    letterbox: bool = True,
) -> np.ndarray:
    """Normalized letterboxed dets [N, 15] -> original-image pixels.
    Mutates and returns `dets`."""
    if len(dets) == 0:
        return np.zeros((0, 15), np.float32)
    ih, iw = image_hw
    if letterbox:
        (ox, oy), (sx, sy) = I.correct_boxes_scale_offset(input_hw, image_hw)
        dets[:, [0, 2]] = (dets[:, [0, 2]] - ox) * sx
        dets[:, [1, 3]] = (dets[:, [1, 3]] - oy) * sy
        dets[:, 5::2] = (dets[:, 5::2] - ox) * sx
        dets[:, 6::2] = (dets[:, 6::2] - oy) * sy
    dets[:, [0, 2]] *= iw
    dets[:, [1, 3]] *= ih
    dets[:, 5::2] *= iw
    dets[:, 6::2] *= ih
    return dets


class Predictor:
    """Detector app: weights, configs and device in one place.

    `state_dict` is the port's (unfolded) state dict, e.g. from
    `utils.convert.state_dict_from_flax`. With `fold_bn` (the default, as
    in the JAX package) the BatchNorms are folded into the convs, then a
    bfloat16 preset casts the folded weights. Runs on the card unless
    `device` is given.
    """

    def __init__(
        self,
        model_cfg: configs.ModelConfig,
        state_dict,
        predict_cfg: Optional[configs.PredictConfig] = None,
        fold_bn: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.pcfg = predict_cfg or configs.PredictConfig()
        model = build_model(model_cfg, mode="eval", device=self.device)
        model.load_state_dict(state_dict)
        model.eval()
        if fold_bn:
            fold_batchnorm(model)
        self.model = model.to(DTYPES[model_cfg.compute_dtype])
        self._anchors = {}

    def _anchors_for(self, hw: Tuple[int, int]) -> torch.Tensor:
        if hw not in self._anchors:
            self._anchors[hw] = torch.from_numpy(
                A.generate_anchors(self.mcfg.anchors, hw).copy()
            ).to(self.device)
        return self._anchors[hw]

    def _detect(self, images: torch.Tensor):
        """[B, H, W, 3] float32 tensor on the device -> (dets, valid)."""
        hw = tuple(images.shape[1:3])
        with torch.inference_mode():
            return detect_batch(
                self.model,
                images.permute(0, 3, 1, 2),
                self._anchors_for(hw),
                self.pcfg,
                self.mcfg.anchors.variance,
            )

    # -- entry points --------------------------------------------------------

    def detect_preprocessed(self, images):
        """images: [B, H, W, 3] float32, mean-subtracted (numpy or tensor).
        Returns (dets [B, max_out, 15] normalized, valid [B, max_out]) as
        tensors on the device."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        return self._detect(x)

    def detect_image(self, image: np.ndarray) -> np.ndarray:
        """One [H, W, 3] uint8/float image -> [N, 15] pixel-space dets."""
        th, tw = self.pcfg.input_shape
        x = I.serving_front_end(image, (tw, th), self.pcfg.letterbox)[None]
        dets, valid = self.detect_preprocessed(x)
        dets = dets[0][valid[0]].cpu().numpy()
        return undo_letterbox_pixels(
            dets, (th, tw), image.shape[:2], self.pcfg.letterbox
        )

    def get_fps(self, image: np.ndarray, test_interval: int = 100) -> float:
        """Images per second of the detect graph (forward + postprocess)
        on one letterboxed image, timed on the card with CUDA events."""
        if self.device.type != "cuda":
            raise RuntimeError(
                f"get_fps times the card with CUDA events; this Predictor "
                f"runs on {self.device}"
            )
        th, tw = self.pcfg.input_shape
        x = torch.from_numpy(I.serving_front_end(image, (tw, th))[None]).to(self.device)
        self._detect(x)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(test_interval):
            self._detect(x)
        end.record()
        end.synchronize()
        return test_interval / (start.elapsed_time(end) / 1000.0)
