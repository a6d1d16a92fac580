"""Dataset conversion tools.

A copy of `jabd_tpu/recognition/convert.py`; `.bin` files decode through
the port's `recognition/data.load_bin_dataset` (PIL).

Reference: convert.py — (a) mxnet .rec -> per-class jpg tree (:14-48),
(b) insightface .bin -> bcolz carray (:50-71). Neither mxnet nor bcolz
need to exist on the host; here:
  (a) rec conversion is gated behind an optional mxnet import with a
      clear error (the format is mxnet-proprietary);
  (b) .bin converts to a plain numpy memfile (`memfile/{name}.npy` +
      `{name}_list.npy`) that jabd_tpu_torch.recognition.data reads.
"""

from __future__ import annotations

import os

import numpy as np


def rec_to_images(rec_prefix: str, out_dir: str) -> None:
    """mxnet RecordIO -> class-folder jpg tree (convert.py:14-48)."""
    try:
        import mxnet as mx  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "mxnet is required to read .rec files and is not available in "
            "this environment; convert the dataset to an image folder on a "
            "machine with mxnet, or train from an image tree directly"
        ) from e
    import numbers

    import mxnet as mx
    from PIL import Image

    path_imgidx = rec_prefix + ".idx"
    path_imgrec = rec_prefix + ".rec"
    imgrec = mx.recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
    s = imgrec.read_idx(0)
    header, _ = mx.recordio.unpack(s)
    max_idx = int(header.label[0])
    for idx in range(1, max_idx):
        s = imgrec.read_idx(idx)
        header, img = mx.recordio.unpack_img(s)
        label = (
            int(header.label)
            if isinstance(header.label, numbers.Number)
            else int(header.label[0])
        )
        d = os.path.join(out_dir, str(label))
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img[:, :, ::-1]).save(
            os.path.join(d, f"{idx}.jpg")
        )


def bin_to_memfile(
    bin_path: str, out_dir: str, image_size: int = 112
) -> None:
    """insightface verification .bin -> numpy memfile pair
    (bcolz-free version of convert.py:50-71)."""
    from jabd_tpu_torch.recognition.data import load_bin_dataset

    name = os.path.splitext(os.path.basename(bin_path))[0]
    data, issame = load_bin_dataset(bin_path, image_size)
    mem_dir = os.path.join(out_dir, name, "memfile")
    os.makedirs(mem_dir, exist_ok=True)
    np.save(os.path.join(mem_dir, f"{name}.npy"), data)
    np.save(os.path.join(out_dir, f"{name}_list.npy"), issame)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("rec2img")
    sp.add_argument("rec_prefix")
    sp.add_argument("out_dir")
    sp = sub.add_parser("bin2memfile")
    sp.add_argument("bin_path")
    sp.add_argument("out_dir")
    sp.add_argument("--image-size", type=int, default=112)
    args = p.parse_args()
    if args.cmd == "rec2img":
        rec_to_images(args.rec_prefix, args.out_dir)
    else:
        bin_to_memfile(args.bin_path, args.out_dir, args.image_size)
