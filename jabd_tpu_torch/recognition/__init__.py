"""Face-recognition half of the port (AdaFace-style): the IR / IR-SE
embedders (net.py), the margin heads (heads.py), the training
augmentation on the host (data.py) and on the card (device_augment.py),
the SGD train step and `fit` (train.py), BatchNorm folding, the ArcFace
alignment, the reference's checkpoint names, the verification, TinyFace
and IJB-S evaluators and the recognition CLI. Port of
`jabd_tpu/recognition`, with its class-sharded head over a process group
(parallel.py).
"""

from jabd_tpu_torch.recognition.heads import build_head  # noqa: F401
from jabd_tpu_torch.recognition.net import IRBackbone, build_model  # noqa: F401
