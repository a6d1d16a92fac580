"""TinyFace identification test harness.

A copy of `jabd_tpu/recognition/tinyface.py` (numpy only).

Port of validation_lq/tinyface_helper.py: the official
probe/gallery/distractor protocol (gallery_match_img_ID_pairs.mat /
probe_img_ID_pairs.mat), filename-derived labels
(`<subject>_...` -> int, distractors labeled -100), and rank-1/5/20
identification over cosine scores (TinyFaceTest.init_proto :48-66,
test_identification :66-78). Batched feature extraction with flip-TTA
comes from jabd_tpu_torch.recognition.train.extract_embeddings_tta
(validate_tinyface.py:70-110's infer loop).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from jabd_tpu_torch.recognition.identification import DIR_FAR, inner_product


def get_all_files(root: str, extensions=(".jpg", ".png", ".jpeg")) -> List[str]:
    out = []
    for dirpath, _, filenames in os.walk(root):
        out += [os.path.join(dirpath, f) for f in filenames]
    if extensions is None:
        return sorted(out)
    return sorted(
        f for f in out if os.path.splitext(f)[1].lower() in extensions
    )


def label_from_path(path: str) -> int:
    """`<subject-id>_...` filename convention (tinyface_helper.py:46)."""
    return int(os.path.basename(path).split("_")[0])


class TinyFaceTest:
    def __init__(
        self,
        tinyface_root: str,
        alignment_dir_name: str = "aligned_pad_0.1_pad_high",
    ):
        import scipy.io as sio

        self.root = tinyface_root
        gallery_dict = sio.loadmat(
            os.path.join(
                tinyface_root,
                "tinyface/Testing_Set/gallery_match_img_ID_pairs.mat",
            )
        )
        probe_dict = sio.loadmat(
            os.path.join(
                tinyface_root, "tinyface/Testing_Set/probe_img_ID_pairs.mat"
            )
        )
        align = os.path.join(tinyface_root, alignment_dir_name)
        self.probe_paths = [
            os.path.join(align, "Probe", p[0].item())
            for p in probe_dict["probe_set"]
        ]
        self.gallery_paths = [
            os.path.join(align, "Gallery_Match", p[0].item())
            for p in gallery_dict["gallery_set"]
        ]
        self.distractor_paths = get_all_files(
            os.path.join(align, "Gallery_Distractor")
        )
        self.image_paths = (
            self.probe_paths + self.gallery_paths + self.distractor_paths
        )
        self._init_proto()

    def _init_proto(self):
        n_p = len(self.probe_paths)
        n_g = len(self.gallery_paths)
        n_d = len(self.distractor_paths)
        self.indices_probe = np.arange(n_p)
        self.indices_gallery = np.arange(n_p, n_p + n_g + n_d)
        self.labels_probe = np.asarray(
            [label_from_path(p) for p in self.probe_paths]
        )
        self.labels_gallery = np.concatenate(
            [
                [label_from_path(p) for p in self.gallery_paths],
                np.full(n_d, -100),
            ]
        )

    def test_identification(
        self, features: np.ndarray, ranks: Sequence[int] = (1, 5, 20)
    ) -> Dict[int, float]:
        """features: [len(image_paths), D] aligned with self.image_paths."""
        score = inner_product(
            features[self.indices_probe], features[self.indices_gallery]
        )
        label = (
            self.labels_probe[:, None] == self.labels_gallery[None, :]
        )
        DIRs, _, _ = DIR_FAR(score, label, ranks=list(ranks), FARs=[1.0])
        return {r: float(d) for r, d in zip(ranks, np.atleast_1d(DIRs))}
