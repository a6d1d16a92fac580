"""IJB-S protocol metadata ingestion.

A copy of `jabd_tpu/recognition/ijbs_proto.py` (numpy only).

Port of the reference's protocol-file parsing
(validation_lq/PFE/ijbs.py:50-360: `IJBSTest.init_proto` +
`initialize_indices`) and the feature plumbing of
validation_lq/evaluate_helper.py:18-88 / validate_IJB_S.py:88-106
(`pre_norm_vector_add_cos`: per-image features are pre-multiplied by
their norms, template fusion is mean + l2-normalize, comparison is the
inner product; templates whose media have no extracted features score
as zero vectors).

Protocol directory layout (the IJB-S distribution's cs6 protocol files):
  cs6_metadata.csv                              subject_id,media_path,...
  cs6_surveillance_to_single-booking_probe.csv  one video name per line
  cs6_surveillance_to_surveillance_probe.csv    one video name per line
  cs6_uav_to_single-booking_probe.csv           video or image per line
  galleries/cs6_surveillance_to_single_g1.csv   _,subject_id,image,...
  galleries/cs6_surveillance_to_single_g2.csv
  galleries/cs6_surveillance_to_booking_g1.csv  _,subject_id,image,...
  galleries/cs6_surveillance_to_booking_g2.csv
  galleries/cs6_surveillance_to_surveillance_g1.csv  _,subject_id,video,...
  galleries/cs6_surveillance_to_surveillance_g2.csv

Intentional deviation: where the reference de-duplicates with
`list(set(...))` (arbitrary iteration order), this port keeps
first-occurrence order — a pure permutation of templates, which leaves
every DIR/FAR metric unchanged but makes runs reproducible.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from jabd_tpu_torch.recognition import ijbs as IJ


@dataclasses.dataclass
class MediaTemplate:
    """A template described by media names, before features exist
    (PFE/ijbs.py:39-50)."""

    subject_id: int
    videos: Optional[List[str]] = None  # e.g. ['videos/4012.mp4']
    images: Optional[List[str]] = None  # e.g. ['img/1234.png']
    indices: Optional[np.ndarray] = None  # rows into the feature matrix


def _read_rows(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f.readlines()[1:] if ln.strip()]


def _dedup(seq):
    seen, out = set(), []
    for x in seq:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


class IJBSProtocol:
    """all_templates + slot-name -> template-index arrays
    (the reference's all_template_list / protocol_template_indices)."""

    def __init__(self):
        self.all_templates: List[MediaTemplate] = []
        self.slots: Dict[str, np.ndarray] = {}

    # -- init_proto (PFE/ijbs.py:57-300) ------------------------------------

    @classmethod
    def from_protocol_dir(cls, folder: str) -> "IJBSProtocol":
        self = cls()
        meta_rows = _read_rows(os.path.join(folder, "cs6_metadata.csv"))
        meta = [(r.split(",")[0], r.split(",")[1]) for r in meta_rows]

        # Video templates: one per (subject, video) pair (:68-84).
        video_meta = _dedup(
            [(sid, m) for sid, m in meta if m.startswith("videos")]
        )
        video_index = {pair: i for i, pair in enumerate(video_meta)}
        subject_videos: Dict[int, List[int]] = {}
        for i, (sid, vname) in enumerate(video_meta):
            t = MediaTemplate(subject_id=int(sid), videos=[vname])
            self.all_templates.append(t)
            subject_videos.setdefault(t.subject_id, []).append(i)

        gdir = os.path.join(folder, "galleries")

        # Video galleries g1/g2 (:86-115).
        for g in (1, 2):
            rows = _read_rows(
                os.path.join(
                    gdir, f"cs6_surveillance_to_surveillance_g{g}.csv"
                )
            )
            pairs = _dedup(
                [(r.split(",")[1], r.split(",")[2]) for r in rows]
            )
            self.slots[f"video_gallery{g}"] = np.asarray(
                [video_index[p] for p in pairs], int
            )

        # Video-to-image probes (:117-130).
        probe_videos = set(
            _read_rows(
                os.path.join(
                    folder, "cs6_surveillance_to_single-booking_probe.csv"
                )
            )
        )
        self.slots["video2image_probe"] = np.asarray(
            [i for i, (_, v) in enumerate(video_meta) if v in probe_videos],
            int,
        )

        # Video-to-video probes + multi-view templates (:132-167).
        vv = set(
            _read_rows(
                os.path.join(
                    folder, "cs6_surveillance_to_surveillance_probe.csv"
                )
            )
        )
        v2v = [i for i, (_, v) in enumerate(video_meta) if v in vv]
        self.slots["video2video_probe"] = np.asarray(v2v, int)
        mv = []
        for subject in _dedup(
            [self.all_templates[i].subject_id for i in v2v]
        ):
            t = MediaTemplate(
                subject_id=subject,
                videos=[
                    video_meta[x][1] for x in subject_videos[subject]
                ],
            )
            mv.append(len(self.all_templates))
            self.all_templates.append(t)
        self.slots["multiview_video_probe"] = np.asarray(mv, int)

        # UAV probes: video rows reuse video templates; image rows make
        # single-image templates with the subject looked up in the
        # metadata (:169-195).
        uav = []
        for media in _read_rows(
            os.path.join(folder, "cs6_uav_to_single-booking_probe.csv")
        ):
            if media.startswith("videos"):
                uav += [
                    i for i, (_, v) in enumerate(video_meta) if v == media
                ]
            else:
                sid = next(
                    int(s) for s, m in meta if m == media
                )
                uav.append(len(self.all_templates))
                self.all_templates.append(
                    MediaTemplate(subject_id=sid, images=[media])
                )
        self.slots["uav_probe"] = np.asarray(uav, int)

        # Single-image galleries: one template per row (:197-230).
        for g in (1, 2):
            rows = _read_rows(
                os.path.join(gdir, f"cs6_surveillance_to_single_g{g}.csv")
            )
            idxs = []
            for r in rows:
                p = r.split(",")
                idxs.append(len(self.all_templates))
                self.all_templates.append(
                    MediaTemplate(subject_id=int(p[1]), images=[p[2]])
                )
            self.slots[f"single_image_gallery{g}"] = np.asarray(idxs, int)

        # Booking galleries: one template per subject holding all of the
        # subject's booking stills (:232-282).
        for g in (1, 2):
            rows = _read_rows(
                os.path.join(gdir, f"cs6_surveillance_to_booking_g{g}.csv")
            )
            parsed = [(int(r.split(",")[1]), r.split(",")[2]) for r in rows]
            idxs = []
            for subject in _dedup([s for s, _ in parsed]):
                idxs.append(len(self.all_templates))
                self.all_templates.append(
                    MediaTemplate(
                        subject_id=subject,
                        images=[m for s, m in parsed if s == subject],
                    )
                )
            self.slots[f"booking_image_gallery{g}"] = np.asarray(idxs, int)
        return self

    # -- initialize_indices (PFE/ijbs.py:316-359) ----------------------------

    def initialize_indices(self, image_paths: Sequence[str]) -> None:
        """Map each template's media names to rows of the extracted
        feature matrix via the aligned-crop path convention:
        `<subject_id>/videos_<video>_<frame...>.jpg` for video frames and
        `<subject_id>/img_<name>.jpg` for stills."""
        path_dict: Dict[str, List[int]] = {}
        for i, path in enumerate(image_paths):
            sid = os.path.basename(os.path.dirname(path))
            fname = os.path.basename(path)
            if fname.startswith("videos"):
                parts = fname.split("_")
                key = f"{sid}_{parts[0]}_{parts[1]}"
                path_dict.setdefault(key, []).append(i)
            elif fname.startswith("img"):
                key = f"{sid}_{os.path.splitext(fname)[0]}"
                path_dict.setdefault(key, []).append(i)

        for t in self.all_templates:
            indices: List[int] = []
            for media in (t.videos or []) + (t.images or []):
                d, f = media.split("/")
                key = f"{t.subject_id}_{d}_{os.path.splitext(f)[0]}"
                indices.extend(path_dict.get(key, []))
            t.indices = (
                np.asarray(indices, int) if indices else None
            )

    # -- feature plumbing (evaluate_helper.py:60-88) --------------------------

    def build_test(
        self,
        features: np.ndarray,  # [N, D] per-image embeddings
        norms: Optional[np.ndarray] = None,  # [N] or [N, 1]
        fuse_match_method: str = "pre_norm_vector_add_cos",
    ) -> IJ.IJBSTest:
        """Aggregate per-image features into per-template features and
        return the protocol runner.

        pre_norm_vector_add_cos (validate_IJB_S.py:35,104-106): features
        are pre-multiplied by their norms, then template fusion is
        mean + l2-normalize (PFE/utils.py:211-214). mean_cos skips the
        norm pre-multiply. Feature-less templates score as zero vectors
        (evaluate_helper.py:78-88).
        """
        if fuse_match_method == "pre_norm_vector_add_cos":
            if norms is None:
                raise ValueError("pre_norm_vector_add_cos requires norms")
            feats = features * np.asarray(norms).reshape(-1, 1)
        elif fuse_match_method == "mean_cos":
            feats = features
        else:
            raise ValueError(
                f"not a correct fuse_match_method {fuse_match_method!r}"
            )

        dim = features.shape[1]
        slot_templates: Dict[str, List[IJ.Template]] = {}
        for name, idxs in self.slots.items():
            ts = []
            for i in idxs:
                mt = self.all_templates[i]
                if mt.indices is not None:
                    feature = IJ.aggregate_template(feats, mt.indices)
                else:
                    feature = np.zeros(dim, np.float32)
                ts.append(
                    IJ.Template(
                        subject_id=mt.subject_id,
                        indices=mt.indices,
                        feature=feature,
                    )
                )
            slot_templates[name] = ts
        return IJ.IJBSTest(slot_templates)
