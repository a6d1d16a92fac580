"""Inference: the detect graph and the `Predictor` entry points.

Port of `postprocess_outputs`, `detect_batch`, `undo_letterbox_pixels`
and `Predictor` (`__init__`, `detect_preprocessed`, `detect_images`,
`detect_image`, `detect_multiscale`, `quantize_int8`, `get_fps`,
`get_map_txt_rows`) of `jabd_tpu/predict.py`, with both of its mesh
modes: data (a replica per mesh entry, the batch split across them, K1 in
each) and spatial (each image's height split across the entries,
parallel/spatial.py; K1 once, on the first). One batch runs on the
device as forward -> top-k of the scores -> decode -> greedy NMS (the
CUDA kernel on the card) -> compaction to fixed [B, max_detections, 15]
rows plus a valid mask; the host letterboxes before (or plans the
letterbox that the device applies, in `detect_images`) and scales to
pixels after. Each entry point opens a `jabd.detect` span around the
call and one span per stage inside it (utils/tracing.py: recorded only
while a torch profiler records).

Detection row layout: [x1, y1, x2, y2, score, 10 landmark coords].
"""

from __future__ import annotations

import time
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
from jabd_tpu_torch.ops.image import undo_letterbox_pixels
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.parallel import spatial as S
from jabd_tpu_torch.utils import tracing as T


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
    with T.span("jabd.detect.select"):
        boxes, scores, valid, landms = select_candidates(
            loc, cls, landm, anchors, pcfg, variances
        )
    with T.span("jabd.detect.k1"):
        keep = keep_fn(boxes, valid, pcfg.nms_iou, kind=pcfg.nms_kind)
    with T.span("jabd.detect.compact"):
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
    with T.span("jabd.detect.forward", images.device):
        loc, cls, landm = model(images)
    return postprocess_outputs(loc, cls, landm, anchors, pcfg, variances)


def rescale_pixels(dets: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Scale [N, 15] pixel dets (boxes and landmarks) by (sx, sy) in
    place, from a pre-scaled image back to its source."""
    dets[:, [0, 2]] *= sx
    dets[:, [1, 3]] *= sy
    dets[:, 5::2] *= sx
    dets[:, 6::2] *= sy
    return dets


def map_txt_rows(dets: np.ndarray) -> np.ndarray:
    """[N, 15] pixel dets -> the WIDER evaluator's [N, 5] x y w h score
    rows, by descending score (a stable sort)."""
    if len(dets) == 0:
        return np.zeros((0, 5), np.float32)
    rows = np.stack(
        [dets[:, 0], dets[:, 1], dets[:, 2] - dets[:, 0], dets[:, 3] - dets[:, 1], dets[:, 4]],
        axis=1,
    )
    return rows[np.argsort(-rows[:, 4], kind="stable")]


class Predictor:
    """Detector app: weights, configs and device in one place.

    `state_dict` is the port's (unfolded) state dict, e.g. from
    `utils.convert.state_dict_from_flax`. With `fold_bn` (the default, as
    in the JAX package) the BatchNorms are folded into the convs, then a
    bfloat16 preset casts the folded weights. Runs on the card unless
    `device` is given. Raises ValueError for a model with an IoU head.

    `mesh`: a local mesh (parallel/mesh.py::make_mesh) of size > 1 serves
    data-parallel, the reference's `nn.DataParallel` wrap: one replica of
    the (folded, cast) model per mesh entry, the first on `mesh.devices[0]`
    (which is then `device`); each batch is split across the replicas,
    each runs the whole detect graph on its rows (K1 per replica on the
    card), and the rows are concatenated on the first device. Batches must
    divide the mesh size.

    `partition="spatial"` with such a mesh is the latency mode: the model
    on `mesh.devices[0]`, its weights copied once to each further card,
    and each image's height split into equal row blocks, one per entry,
    each computed on its entry's device (parallel/spatial.py: halo rows
    for every conv and pool, global-context ops gathered, deep levels
    gathered once they no longer split). Any batch size goes, 1 included; the height must
    divide the mesh size (JAX's ValueError). The head maps are gathered on
    the first device, where top-k, decode, K1 and compaction run once, as
    JAX's all-replicated post-process computes. A mesh of size 1 is the
    plain path in either mode.
    """

    def __init__(
        self,
        model_cfg: configs.ModelConfig,
        state_dict,
        predict_cfg: Optional[configs.PredictConfig] = None,
        fold_bn: bool = True,
        device=None,
        mesh: Optional[M.Mesh] = None,
        partition: str = "data",
    ):
        if model_cfg.with_iou_head:
            raise ValueError(
                f"model {model_cfg.name!r} has an IoU head (a fourth output); "
                "detection takes (loc, conf, landm) only, as in the JAX package"
            )
        if partition not in ("data", "spatial"):
            raise ValueError(f"partition must be 'data' or 'spatial', got {partition!r}")
        self.partition = partition
        self.mesh = mesh if M.is_local_sharded(mesh) else None
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.mcfg = model_cfg
        self.pcfg = predict_cfg or configs.PredictConfig()
        model = build_model(model_cfg, mode="eval", device=self.device)
        model.load_state_dict(state_dict)
        model.eval()
        if fold_bn:
            fold_batchnorm(model)
        self.model = model.to(DTYPES[model_cfg.compute_dtype])
        self._replicate()
        self._anchors = {}

    @property
    def _spatial(self) -> bool:
        return self.mesh is not None and self.partition == "spatial"

    def _replicate(self) -> None:
        """One copy of the model per further entry of a data mesh; on a
        spatial mesh, the one model with its modules' spatial rules and its
        weights copied to each further card (parallel/spatial.py)."""
        self.replicas = [self.model]
        if self._spatial:
            S.partition_model(self.model, self.mesh.devices)
        elif self.mesh is not None:
            self.replicas += M.replicate_tree(self.model, M.Mesh(self.mesh.devices[1:]))

    def _anchors_for(self, hw: Tuple[int, int], device=None) -> torch.Tensor:
        device = torch.device(device or self.device)
        if (hw, device) not in self._anchors:
            self._anchors[hw, device] = torch.from_numpy(
                A.generate_anchors(self.mcfg.anchors, hw).copy()
            ).to(device)
        return self._anchors[hw, device]

    def _check_batch(self, b: int) -> None:
        if self.mesh is not None and not self._spatial and b % self.mesh.size:
            raise ValueError(
                f"batch size {b} must divide the serving mesh size "
                f"{self.mesh.size} (pad the batch or shrink the mesh)"
            )

    def _detect_parts(self, parts):
        """One [b, H, W, 3] float32 tensor per replica, on its device ->
        (dets, valid) of their rows in order, on the first device. Every
        replica's graph is launched before any result is read."""
        outs = []
        with torch.inference_mode():
            for model, images in zip(self.replicas, parts):
                hw = tuple(images.shape[1:3])
                outs.append(detect_batch(
                    model,
                    images.permute(0, 3, 1, 2),
                    self._anchors_for(hw, images.device),
                    self.pcfg,
                    self.mcfg.anchors.variance,
                ))
            if len(outs) == 1:
                return outs[0]
            return tuple(torch.cat([o[i].to(self.device) for o in outs]) for i in range(2))

    def _detect(self, images: torch.Tensor):
        """[B, H, W, 3] float32 tensor on the device -> (dets, valid)."""
        if self.mesh is None:
            return self._detect_parts([images])
        if self._spatial:
            return self._detect_spatial(images)
        self._check_batch(images.shape[0])
        return self._detect_parts(M.shard_batch(images, self.mesh))

    def _detect_spatial(self, images: torch.Tensor):
        """The forward over row blocks of every image, then the
        post-process once on the first device, where the heads arrive
        gathered."""
        hw = tuple(images.shape[1:3])
        with torch.inference_mode():
            with T.span("jabd.detect.forward", self.device):
                loc, cls, landm = self.model(S.shard_rows(images.permute(0, 3, 1, 2), self.mesh.devices))
            return postprocess_outputs(loc, cls, landm, self._anchors_for(hw), self.pcfg, self.mcfg.anchors.variance)

    # -- entry points --------------------------------------------------------

    def detect_preprocessed(self, images):
        """images: [B, H, W, 3] float32, mean-subtracted (numpy or tensor).
        Returns (dets [B, max_out, 15] normalized, valid [B, max_out]) as
        tensors on the device."""
        with T.span("jabd.detect"):
            with T.span("jabd.detect.upload"):
                x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
            return self._detect(x)

    def detect_images(self, images) -> list:
        """Detections of uint8 [H_i, W_i, 3] images of any sizes in one
        batch: each image's letterbox is planned on the host as per-row taps
        against one source bucket (`ops/image.py::plan_letterbox`; ceil-128
        of the largest side, capped at 2048, larger sources shrunk first),
        the images' own bytes are copied into a bucket made on the device,
        and the letterbox runs there in one batched call (bfloat16
        matmuls), then `_detect`. Frames differ from the host letterbox by
        rounding only. Returns a list of [N_i, 15] pixel-space dets."""
        if not len(images):
            return []
        th, tw = self.pcfg.input_shape
        # Each replica of a data mesh letterboxes its own rows on its device;
        # a spatial mesh letterboxes on the first device, then shards.
        data_mesh = self.mesh is not None and not self._spatial
        with T.span("jabd.detect"):
            with T.span("jabd.detect.prepare"):
                bh = min(-(-max(i.shape[0] for i in images) // 128) * 128, 2048)
                bw = min(-(-max(i.shape[1] for i in images) // 128) * 128, 2048)
                sources, plans = zip(
                    *(I.plan_letterbox(im, (th, tw), (bh, bw), self.pcfg.letterbox) for im in images)
                )
                self._check_batch(len(images))
                plans = [np.stack(p) for p in zip(*plans)]
                if data_mesh:
                    shards = [(M.rank_rows(len(images), self.mesh, r), d) for r, d in enumerate(self.mesh.devices)]
                else:
                    shards = [(np.arange(len(images)), self.device)]
            with T.span("jabd.detect.upload"):
                pieces = [
                    (I.upload_to_bucket([sources[i] for i in rows], (bh, bw), dev),
                     *(torch.from_numpy(p[rows]).to(dev) for p in plans))
                    for rows, dev in shards
                ]
                T.count("detect.upload_bytes", sum(s.nbytes for s in sources) + sum(p.nbytes for p in plans))
            frames = []
            with torch.inference_mode():
                for piece in pieces:
                    with T.span("jabd.detect.letterbox"):
                        frames.append(I.letterbox_batch_device(*piece))
            dets_b, valid_b = self._detect_parts(frames) if data_mesh else self._detect(frames[0])
            with T.span("jabd.detect.download"):
                dets_b, valid_b = dets_b.cpu().numpy(), valid_b.cpu().numpy()
            with T.span("jabd.detect.finish"):
                return [
                    undo_letterbox_pixels(dets_b[i][valid_b[i]], (th, tw), im.shape[:2], self.pcfg.letterbox)
                    for i, im in enumerate(images)
                ]

    def detect_image(self, image: np.ndarray) -> np.ndarray:
        """One [H, W, 3] uint8/float image -> [N, 15] pixel-space dets."""
        th, tw = self.pcfg.input_shape
        x = I.serving_front_end(image, (tw, th), self.pcfg.letterbox)[None]
        dets, valid = self.detect_preprocessed(x)
        dets = dets[0][valid[0]].cpu().numpy()
        return undo_letterbox_pixels(
            dets, (th, tw), image.shape[:2], self.pcfg.letterbox
        )

    def detect_multiscale(self, image: np.ndarray, scales=(0.5, 1.0, 1.5)) -> np.ndarray:
        """Image-pyramid detection: per scale a float32 cv2-cubic pre-scale
        (`ops/image.py::cubic_resize_np`, sides at least 32 px) and
        `detect_image`, the dets scaled back to the image; then the union
        through the host's greedy NMS (`nms_numpy`, its count varies per
        image), cut to max_detections. Returns [N, 15] pixel-space dets."""
        ih, iw = image.shape[:2]
        all_dets = []
        for s in scales:
            sw, sh = max(int(iw * s), 32), max(int(ih * s), 32)
            d = self.detect_image(I.cubic_resize_np(image, (sw, sh)))
            if len(d):
                rescale_pixels(d, iw / sw, ih / sh)
                all_dets.append(d)
        if not all_dets:
            return np.zeros((0, 15), np.float32)
        merged = np.concatenate(all_dets, 0)
        keep = N.nms_numpy(merged[:, :4], merged[:, 4], iou_threshold=self.pcfg.nms_iou)
        return merged[keep[: self.pcfg.max_detections]]

    def get_map_txt_rows(self, image: np.ndarray) -> np.ndarray:
        """Rows for the WIDER evaluator: [N, 5] x y w h score, by
        descending score (a stable sort)."""
        return map_txt_rows(self.detect_image(image))

    def quantize_int8(self, sample_images, search_clip: bool = False, score_fn=None) -> int:
        """Switch serving to int8 convs (models/quantize.py): every folded
        non-depthwise ConvBN runs as an int8 conv. Activation scales are
        calibrated on `sample_images` ([N, H, W, 3] uint8 or float) put
        through the serving recipe: letterbox in the sample's own dtype,
        then float, then mean subtraction. `search_clip` grid-searches a
        global clip ratio below absmax by end-to-end output error on the
        same samples, or by `score_fn(quantized_model) -> float` (lower is
        better) when given. Returns the number of quantized sites; raises
        ValueError for a Predictor built with fold_bn=False."""
        from jabd_tpu_torch.models import quantize as Q

        th, tw = self.pcfg.input_shape
        imgs = np.stack([I.letterbox_np(np.asarray(im), (tw, th)).astype(np.float32) for im in sample_images])
        x = torch.from_numpy(I.preprocess_input_np(imgs)).to(self.device).permute(0, 3, 1, 2)
        calib = Q.calibrate(self.model, [x])
        ratio = 1.0
        if search_clip:
            ratio, _ = Q.search_clip_ratio(self.model, calib, [x], score_fn=score_fn)
        n = Q.quantize_model(self.model, calib, clip_ratio=ratio)
        self._replicate()
        return n

    def get_fps(self, image: np.ndarray, test_interval: int = 100, method: str = "chained") -> float:
        """Images per second of the detect graph (forward + postprocess)
        on one letterboxed image, on the card. `method="chained"` times
        `test_interval` back-to-back batches with CUDA events; `"wall"`
        reads the host clock around the same loop, synchronized before
        and after (the reference's harness, predict.py:253-333)."""
        if method not in ("chained", "wall"):
            raise ValueError(f"method must be 'chained' or 'wall', got {method!r}")
        if self.device.type != "cuda":
            raise RuntimeError(
                f"get_fps times the card with CUDA events; this Predictor "
                f"runs on {self.device}"
            )
        th, tw = self.pcfg.input_shape
        x = torch.from_numpy(I.serving_front_end(image, (tw, th))[None]).to(self.device)
        self._detect(x)  # warm-up
        if method == "wall":
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(test_interval):
                self._detect(x)
            torch.cuda.synchronize(self.device)
            return test_interval / (time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(test_interval):
            self._detect(x)
        end.record()
        end.synchronize()
        return test_interval / (start.elapsed_time(end) / 1000.0)
