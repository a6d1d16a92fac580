"""IJB-S surveillance identification protocols.

A copy of `jabd_tpu/recognition/ijbs.py` (numpy only).

Port of validation_lq/PFE/ijbs.py: templates (a subject's set of video
frames / stills whose features are aggregated into one vector), the
dual-gallery identification measure (closed-set CMC ranks 1/5/10 over the
stacked galleries + open-set DIR averaged over the two galleries at
FAR 0.01/0.1 — ijbs.py:362-397), and the five named protocols
(surveillance-to-single/booking, multiview, surveillance-to-surveillance,
UAV — :399-452). The reference's multiprocessing pair scorer
(comparePairs :454-478) is unnecessary here: scoring is a single matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jabd_tpu_torch.recognition.identification import DIR_FAR, inner_product


@dataclasses.dataclass
class Template:
    """One IJB-S template (ijbs.py:39-50)."""

    subject_id: int
    indices: Optional[np.ndarray] = None  # rows into the feature matrix
    feature: Optional[np.ndarray] = None  # aggregated [D]


def aggregate_template(
    features: np.ndarray,
    indices: np.ndarray,
    norms: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Aggregate frame features into a template feature: norm-weighted
    average re-normalized (the AdaFace fusion applied template-wise)."""
    f = features[indices]
    if norms is not None:
        f = f * norms[indices].reshape(-1, 1)
    fused = f.mean(axis=0)
    return fused / np.clip(np.linalg.norm(fused), 1e-12, None)


def build_templates(
    features: np.ndarray,
    groups: Dict[int, Sequence[int]],
    norms: Optional[np.ndarray] = None,
) -> List[Template]:
    """groups: subject_id -> frame row indices."""
    out = []
    for sid, idxs in groups.items():
        idxs = np.asarray(idxs, int)
        out.append(
            Template(
                subject_id=int(sid),
                indices=idxs,
                feature=aggregate_template(features, idxs, norms),
            )
        )
    return out


def identification(
    template_probe: Sequence[Template],
    template_gallery1: Sequence[Template],
    template_gallery2: Sequence[Template],
    compare_func: Callable = inner_product,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dual-gallery protocol measure (ijbs.py:362-397).

    Returns (closed-set DIRs at ranks [1, 5, 10],
    open-set DIRs at FARs [0.01, 0.1] averaged over the two galleries).
    """
    fp = np.stack([t.feature for t in template_probe])
    lp = np.asarray([t.subject_id for t in template_probe]).reshape(-1, 1)
    fg1 = np.stack([t.feature for t in template_gallery1])
    lg1 = np.asarray([t.subject_id for t in template_gallery1]).reshape(-1, 1)
    fg2 = np.stack([t.feature for t in template_gallery2])
    lg2 = np.asarray([t.subject_id for t in template_gallery2]).reshape(-1, 1)

    scores1 = compare_func(fp, fg1)
    scores2 = compare_func(fp, fg2)
    closed, _, _ = DIR_FAR(
        np.hstack((scores1, scores2)),
        lp == np.vstack((lg1, lg2)).T,
        ranks=[1, 5, 10],
    )
    open1, _, _ = DIR_FAR(scores1, lp == lg1.T, FARs=[0.01, 0.1])
    open2, _, _ = DIR_FAR(scores2, lp == lg2.T, FARs=[0.01, 0.1])
    return np.atleast_1d(closed), (
        np.atleast_1d(open1) + np.atleast_1d(open2)
    ) / 2.0


class IJBSTest:
    """Protocol runner over a template registry.

    protocol_templates maps the reference's protocol slot names
    ('video2image_probe', 'single_image_gallery1', ...) to Template lists
    (ijbs.py:399-452)."""

    PROTOCOLS = {
        "surveillance_to_single": (
            "video2image_probe",
            "single_image_gallery1",
            "single_image_gallery2",
        ),
        "surveillance_to_booking": (
            "video2image_probe",
            "booking_image_gallery1",
            "booking_image_gallery2",
        ),
        "multiview_surveillance_to_booking": (
            "multiview_video_probe",
            "booking_image_gallery1",
            "booking_image_gallery2",
        ),
        "surveillance_to_surveillance": (
            "video2video_probe",
            "video_gallery1",
            "video_gallery2",
        ),
        "uav_surveillance_to_booking": (
            "uav_probe",
            "booking_image_gallery1",
            "booking_image_gallery2",
        ),
    }

    def __init__(self, protocol_templates: Dict[str, List[Template]]):
        self.slots = protocol_templates

    def run(self, protocol: str):
        probe_key, g1_key, g2_key = self.PROTOCOLS[protocol]
        return identification(
            self.slots[probe_key], self.slots[g1_key], self.slots[g2_key]
        )

    def run_all(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        out = {}
        for name, (p, g1, g2) in self.PROTOCOLS.items():
            if p in self.slots and g1 in self.slots and g2 in self.slots:
                out[name] = self.run(name)
        return out
