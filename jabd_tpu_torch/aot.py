"""Ahead-of-time serving artifacts (`torch.export`).

Port of `export_detector`, `AotDetector`, `export_embedder`,
`AotEmbedder` and `load_exported` of `jabd_tpu/aot.py`. The whole detect
graph of a Predictor (forward -> top-k -> decode -> greedy NMS ->
compaction, anchors held as a constant), or the embedding graph of an IR
backbone, is exported with `torch.export` for one batch size and input
shape, and saved with its weights; the serving host loads it and calls it,
with no model code, no preset registry and no trace. Layout:

    <dir>/graph.pt2       torch.export.save of the program (weights inside)
    <dir>/manifest.json   version, kind, model, batch_size, input_shape,
                          platforms, pcfg (the JAX package's keys)

The NMS keep mask is the registered operator `jabd::nms_keep_sorted`
(ops/nms_cuda.py), one node of the graph: a loaded artifact launches the
CUDA kernel K1 on the card, exactly as the live Predictor does. The loading
side imports this module and that operator's registration only.

`platforms` names the torch device the graph was exported on, ("cuda",)
or ("cpu",): an exported graph holds its device in its constants and
weights, so an artifact runs where it was exported and is refused
elsewhere. A Predictor switched to int8 (`quantize_int8`), or a folded or
int8 embedder, exports the graph it runs. A detector artifact serves
data-parallel over a local mesh (`load_exported(mesh=)`): one loaded
program per mesh entry, each running the exported batch.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.ops import nms_cuda  # noqa: F401  (registers jabd::nms_keep_sorted)
from jabd_tpu_torch.parallel import mesh as M

ARTIFACT_VERSION = 1
_GRAPH = "graph.pt2"
_MANIFEST = "manifest.json"


class _DetectGraph(torch.nn.Module):
    """images [B, th, tw, 3] float32 mean-subtracted -> (dets [B,
    max_detections, 15] normalized, valid [B, max_detections])."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        th, tw = predictor.pcfg.input_shape
        self.register_buffer("anchors", predictor._anchors_for((th, tw)))
        self.pcfg = predictor.pcfg
        self.variances = predictor.mcfg.anchors.variance

    def forward(self, images):
        from jabd_tpu_torch.predict import detect_batch

        return detect_batch(self.model, images.permute(0, 3, 1, 2), self.anchors, self.pcfg, self.variances)


def export_detector(
    predictor,
    out_dir: str,
    batch_size: int = 1,
    platforms: Optional[Sequence[str]] = None,
    model_name: str = "",
) -> str:
    """Export `predictor`'s detect graph for [batch_size, *input_shape, 3]
    float32 inputs into `out_dir`. `platforms` defaults to the predictor's
    device type and must equal it. Returns `out_dir`. A Predictor with a
    mesh (either partition) raises, as in the JAX package: export the
    single-device one, and serve the artifact over a mesh with
    `load_exported(mesh=)`."""
    if predictor.mesh is not None:
        raise ValueError(
            "export a single-device Predictor (an artifact is one graph on one device; "
            "load_exported(mesh=) serves it over a data mesh)"
        )
    dev = predictor.device.type
    platforms = tuple(platforms or (dev,))
    if platforms != (dev,):
        raise ValueError(
            f"an artifact runs on the device it was exported on: this Predictor "
            f"runs on {dev!r}, asked for platforms {platforms}"
        )
    th, tw = predictor.pcfg.input_shape
    graph = _DetectGraph(predictor).eval()
    example = torch.zeros((batch_size, th, tw, 3), dtype=torch.float32, device=predictor.device)
    with torch.no_grad():
        program = torch.export.export(graph, (example,))
    program.example_inputs = None  # else the file also holds the zero batch it was traced on
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _GRAPH))
    pcfg = predictor.pcfg
    manifest = {
        "version": ARTIFACT_VERSION,
        "kind": "detector",
        "model": model_name,
        "batch_size": batch_size,
        "input_shape": [th, tw],
        "platforms": list(platforms),
        "pcfg": {
            "confidence": pcfg.confidence,
            "nms_iou": pcfg.nms_iou,
            "nms_kind": pcfg.nms_kind,
            "letterbox": pcfg.letterbox,
            "max_detections": pcfg.max_detections,
            "pre_nms_topk": pcfg.pre_nms_topk,
        },
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class AotDetector:
    """Serving-side twin of `Predictor`, driven by an artifact only:
    `detect_preprocessed` at the exported batch size, `detect_image` for
    one image (padded to that batch).

    With a local `mesh` of size > 1 there is one program per mesh entry
    (`programs`) and the artifact's batch is each one's: `batch_size` is
    artifact batch x mesh size, split across them, the rows concatenated
    on the first device."""

    def __init__(self, programs, manifest: dict, device: torch.device, mesh: Optional[M.Mesh] = None):
        programs = programs if isinstance(programs, (list, tuple)) else [programs]
        self._fns = [p.module() for p in programs]
        self.manifest = manifest
        self.mesh = mesh if M.is_local_sharded(mesh) else None
        self.device = device
        self.batch_size = int(manifest["batch_size"]) * len(self._fns)
        self.input_shape = tuple(manifest["input_shape"])
        self.letterbox = bool(manifest["pcfg"]["letterbox"])

    def detect_preprocessed(self, images):
        """images: [batch_size, th, tw, 3] float32 mean-subtracted (numpy
        or tensor) -> (dets [B, max_out, 15] normalized, valid [B,
        max_out]) as tensors on the device."""
        b = images.shape[0]
        if b != self.batch_size:
            raise ValueError(f"artifact was exported for batch {self.batch_size}, got {b}")
        x = torch.as_tensor(images, dtype=torch.float32)
        if self.mesh is None:
            with torch.no_grad():
                return self._fns[0](x.to(self.device))
        with torch.no_grad():
            outs = [fn(part) for fn, part in zip(self._fns, M.shard_batch(x, self.mesh))]
        return tuple(torch.cat([o[i].to(self.device) for o in outs]) for i in range(2))

    def detect_image(self, image: np.ndarray) -> np.ndarray:
        """One [H, W, 3] uint8/float image -> [N, 15] pixel-space dets
        (the Predictor.detect_image contract)."""
        th, tw = self.input_shape
        x = I.serving_front_end(image, (tw, th), self.letterbox)[None]
        if self.batch_size > 1:
            x = np.concatenate([x, np.zeros((self.batch_size - 1, *x.shape[1:]), x.dtype)])
        dets, valid = self.detect_preprocessed(x)
        dets = dets[0][valid[0]].cpu().numpy()
        return I.undo_letterbox_pixels(dets, (th, tw), image.shape[:2], self.letterbox)


class _EmbedGraph(torch.nn.Module):
    """images [B, S, S, 3] float32 normalized -> (emb [B, 512], norm [B, 1])."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images):
        return self.model(images.permute(0, 3, 1, 2))


def export_embedder(
    model,
    out_dir: str,
    batch_size: int = 256,
    image_size: int = 112,
    platforms: Optional[Sequence[str]] = None,
    model_name: str = "",
) -> str:
    """Export an IR backbone's embedding graph (folded, int8 or neither, in
    its own dtype) for [batch_size, S, S, 3] float32 normalized inputs into
    `out_dir`. `platforms` defaults to the model's device type and must
    equal it. Returns `out_dir`."""
    dev = next(model.parameters()).device
    platforms = tuple(platforms or (dev.type,))
    if platforms != (dev.type,):
        raise ValueError(
            f"an artifact runs on the device it was exported on: this model "
            f"runs on {dev.type!r}, asked for platforms {platforms}"
        )
    example = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = torch.export.export(_EmbedGraph(model.eval()), (example,))
    program.example_inputs = None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _GRAPH))
    manifest = {
        "version": ARTIFACT_VERSION,
        "kind": "embedder",
        "model": model_name,
        "batch_size": batch_size,
        "input_shape": [image_size, image_size],
        "platforms": list(platforms),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class AotEmbedder:
    """Serving-side embedder driven by an artifact only."""

    def __init__(self, program, manifest: dict, device: torch.device):
        self._fn = program.module()
        self.manifest = manifest
        self.device = device
        self.batch_size = int(manifest["batch_size"])

    def embed(self, images):
        """[batch_size, S, S, 3] float32 normalized (numpy or tensor) ->
        (embeddings [B, 512], norms [B, 1]) as tensors on the device."""
        if images.shape[0] != self.batch_size:
            raise ValueError(f"artifact batch is {self.batch_size}, got {images.shape[0]}")
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            return self._fn(x)


_KINDS = {"detector": AotDetector, "embedder": AotEmbedder}


def load_exported(out_dir: str, device=None, mesh: Optional[M.Mesh] = None):
    """Load an artifact directory to run on `device` (the card unless
    given): an AotDetector or an AotEmbedder, by the manifest's kind.
    Raises ValueError for an artifact of a newer version or an unknown
    kind, or one exported for another device type.

    `mesh` (a detector over a local mesh of size > 1): one program per
    mesh entry, moved to that entry's device where it differs from the
    export's (`torch.export.passes.move_to_device_pass`); the first entry
    is the device."""
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["version"] > ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {manifest['version']} is newer than this loader ({ARTIFACT_VERSION})"
        )
    if manifest["kind"] not in _KINDS:
        raise ValueError(f"unknown artifact kind {manifest['kind']!r}")
    devices = mesh.devices if mesh is not None else [resolve_device(device)]
    mesh = mesh if M.is_local_sharded(mesh) else None
    for dev in devices:
        if dev.type not in manifest["platforms"]:
            raise ValueError(
                f"artifact was exported for {manifest['platforms']}, but it is loaded for {dev.type!r}"
            )
    path = os.path.join(out_dir, _GRAPH)
    if mesh is None:
        return _KINDS[manifest["kind"]](torch.export.load(path), manifest, devices[0])
    if manifest["kind"] != "detector":
        raise ValueError("a mesh serves detector artifacts only")
    programs = [_on_device(torch.export.load(path), dev) for dev in devices]
    return AotDetector(programs, manifest, devices[0], mesh)


def _on_device(program, device: torch.device):
    """`program` with its weights and constants on `device` (moved only
    where they lie elsewhere)."""
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    if all(not isinstance(t, torch.Tensor) or t.device == device for t in tensors):
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)
