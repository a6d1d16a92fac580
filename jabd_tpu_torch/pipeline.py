"""Detect -> align -> embed -> identify: the two halves joined.

Port of `FacePipeline`, `Gallery` and `enroll_directory` of
`jabd_tpu/pipeline.py`. The detector's 5-point landmarks go through the
ArcFace alignment (recognition/align.py) into an IR embedder:

    pipe = FacePipeline(predictor, model)      # model: recognition.build_model
    dets, embs = pipe.analyze(image)           # [N, 15], [N, 512] unit-norm
    gallery = Gallery(); gallery.enroll("ann", embs[0])
    names = gallery.match(embs)                # cosine identification

`analyze` copies the image to the card once and warps every face there;
crops given to `embed_crops` from the host reach it in one copy. They
are padded to a multiple of `embed_batch` and embedded in chunks of that
fixed size, so every call runs the same shapes whatever the face count.
On the card the detection stage launches the NMS kernel K1 (inside
`detect_image`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.recognition.align import align_from_detections


def normalize_crops(crops):
    """[N, S, S, 3] BGR uint8 -> [N, S, S, 3] RGB float32 in [-1, 1], with
    the operations of `recognition/data.normalize_face` in its order, so
    the values are bit-identical. A numpy array gives a numpy array; a
    tensor gives a tensor on its device, computed there (the divisor is a
    tensor: CUDA turns a division by a Python scalar into a multiply by
    its reciprocal, which may differ in the last bit)."""
    if isinstance(crops, np.ndarray):
        return normalize_crops(torch.from_numpy(crops)).numpy()
    x = crops.flip(-1).float()
    x /= torch.full((), 255.0, device=x.device)
    x -= 0.5
    x /= 0.5
    return x


class FacePipeline:
    """Faces in an image -> identity embeddings.

    `predictor` is a `predict.Predictor` (any detection preset, or None
    when only `embed_crops` or `embed_detections` is used, as `/identify`
    does); `model` an IR
    embedder (`recognition.build_model`, folded or int8 or not).
    `embed_batch` is the fixed embedding batch. Runs on the card unless
    `device` is given."""

    def __init__(self, predictor, model, embed_batch: int = 16, crop_size: int = 112, device=None):
        self.device = resolve_device(device)
        self.predictor = predictor
        self.model = model.to(self.device).eval()
        self.embed_batch = embed_batch
        self.crop_size = crop_size

    def embed_crops(self, crops) -> np.ndarray:
        """[N, S, S, 3] BGR uint8 aligned crops (numpy, or a tensor on the
        pipeline's device) -> [N, 512] float32 unit-norm embeddings (N = 0
        gives an empty [0, 512])."""
        n = len(crops)
        if n == 0:
            return np.zeros((0, self.model.embedding_size), np.float32)
        b = self.embed_batch
        n_pad = -(-n // b) * b
        x = torch.zeros((n_pad, *crops.shape[1:]), dtype=torch.uint8, device=self.device)
        x[:n] = torch.as_tensor(crops).to(self.device)
        x = normalize_crops(x).permute(0, 3, 1, 2)
        with torch.inference_mode():
            embs = [self.model(x[lo : lo + b])[0] for lo in range(0, n, b)]
            return torch.cat(embs)[:n].cpu().numpy()

    def embed_detections(self, image: np.ndarray, dets: np.ndarray) -> np.ndarray:
        """A BGR image and its [N, 15] pixel-space detections -> [N, 512]
        embeddings: the faces aligned on the pipeline's device, then
        embedded."""
        return self.embed_crops(align_from_detections(image, dets, self.crop_size, device=self.device))

    def analyze(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """BGR image -> ([N, 15] pixel-space dets, [N, 512] embeddings)."""
        dets = self.predictor.detect_image(image)
        return dets, self.embed_detections(image, dets)


class Gallery:
    """Named identities with cosine matching. An identity enrolled from
    several photos keeps their mean, normalized again (the validation
    protocols' fusion convention)."""

    def __init__(self):
        self.names: List[str] = []
        self._embs: List[np.ndarray] = []

    def enroll(self, name: str, embeddings: np.ndarray):
        e = np.asarray(embeddings, np.float32)
        if e.ndim == 1:
            e = e[None]
        mean = e.mean(axis=0)
        nrm = np.linalg.norm(mean)
        if nrm == 0:
            raise ValueError(f"zero embedding for {name!r}")
        self.names.append(name)
        self._embs.append(mean / nrm)

    @property
    def matrix(self) -> np.ndarray:
        if not self._embs:
            return np.zeros((0, 0), np.float32)
        return np.stack(self._embs)

    def match(self, embeddings: np.ndarray, threshold: float = 0.3) -> List[Tuple[Optional[str], float]]:
        """[N, D] query embeddings -> [(best name or None, cosine)]."""
        out: List[Tuple[Optional[str], float]] = []
        g = self.matrix
        for e in np.atleast_2d(np.asarray(embeddings, np.float32)):
            if g.size == 0:
                out.append((None, -1.0))
                continue
            sims = g @ (e / max(np.linalg.norm(e), 1e-12))
            i = int(np.argmax(sims))
            s = float(sims[i])
            out.append((self.names[i] if s >= threshold else None, s))
        return out

    def save(self, path: str):
        """An npz of `names` (an object array) and `embs`, the JAX
        package's file: either package loads the other's."""
        np.savez(path, names=np.array(self.names, object), embs=self.matrix)

    @classmethod
    def load(cls, path: str) -> "Gallery":
        g = cls()
        data = np.load(path, allow_pickle=True)
        g.names = [str(n) for n in data["names"]]
        g._embs = [np.asarray(e, np.float32) for e in data["embs"]]
        return g


def enroll_directory(pipeline: FacePipeline, gallery_dir: str, min_score: float = 0.0) -> Gallery:
    """A Gallery from a tree of `<gallery_dir>/<name>/*.jpg`: each photo
    gives its highest-score face. Photos PIL cannot decode are skipped."""
    from jabd_tpu_torch.eval.run_wider import decode_bgr

    gallery = Gallery()
    for name in sorted(os.listdir(gallery_dir)):
        person_dir = os.path.join(gallery_dir, name)
        if not os.path.isdir(person_dir):
            continue
        embs = []
        for fn in sorted(os.listdir(person_dir)):
            if not fn.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            try:
                img = decode_bgr(os.path.join(person_dir, fn))
            except (OSError, ValueError):
                continue
            dets, e = pipeline.analyze(img)
            if len(dets) == 0 or dets[:, 4].max() < min_score:
                continue
            embs.append(e[int(np.argmax(dets[:, 4]))])
        if embs:
            gallery.enroll(name, np.stack(embs))
    return gallery
