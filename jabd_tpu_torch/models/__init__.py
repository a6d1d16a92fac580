"""Detector modules of the port (NCHW `nn.Module`s)."""

from jabd_tpu_torch.models.retinaface import RetinaFace, build_model

__all__ = ["RetinaFace", "build_model"]
