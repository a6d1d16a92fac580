"""Face-recognition half of the port (AdaFace-style), inference and
evaluation: the IR / IR-SE embedders (net.py), BatchNorm folding, the
ArcFace alignment, the reference's checkpoint names, the verification,
TinyFace and IJB-S evaluators and the recognition CLI. Port of
`jabd_tpu/recognition`; its training (heads, augmentation, the train step)
comes with the recognition training slice.
"""

from jabd_tpu_torch.recognition.net import IRBackbone, build_model  # noqa: F401
