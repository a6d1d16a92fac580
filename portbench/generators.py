"""Inputs and weights made from the run's seed: WIDER FACE geometry,
smooth image content, face targets, seeded weights and BatchNorm
calibration.

Frozen copies, made on the device, of `chip_smoke.py`'s `smooth_image`,
`wider_rows`, `seeded_state_dict` and `calibrate_batchnorms` (their
distributions kept but for the BatchNorm shift and the attention's query
and key: `seed_weights`), so that later edits of that script cannot move
the benchmark's inputs.

WIDER FACE's geometry (Yang et al., "WIDER FACE: A Face Detection
Benchmark", CVPR 2016): the released images are 1024 px wide; 393,703
faces in 32,203 images, 12.2 per image. Assumed where the paper gives
nothing: the image heights (the aspect ratios a traffic file lists), a
geometric count of faces, face heights log-uniform over 10-500 px, face
widths 0.8-1.0 of the height, 70% of faces with landmarks.

Every seed gets the same amount of work: a detection batch holds the same
number of images of each aspect ratio, and a training batch the same face
counts (quantiles of the geometric law), only their order, content and
places drawn from the seed.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([stream, seed % (1 << 63)])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed((seed * 1_000_003 + stream) % (1 << 63))


def smooth_images(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """n uint8 [h, w, 3] images: uniform noise on a grid 16 times coarser,
    bilinearly upsampled, plus N(0, 4^2) noise, clipped."""
    coarse = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=gen, device=device) * 255.0
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 4.0 * torch.randn(x.shape, generator=gen, device=device)
    return x.clamp_(0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def detect_pool(traffic: dict, seed: int, device) -> List[List[np.ndarray]]:
    """`pool_batches` batches of host uint8 images, WIDER-wide, each batch
    holding `per_aspect` images of every aspect ratio in a seeded order."""
    rng = numpy_rng(seed, 1)
    gen = torch_gen(seed, 1, device)
    width = traffic["image_width"]
    aspects = [tuple(a) for a in traffic["aspects"]]
    n = traffic["pool_batches"] * traffic["per_aspect"]
    by_aspect = {a: smooth_images(gen, n, width * a[1] // a[0], width, device).cpu().numpy() for a in aspects}
    batches = []
    for b in range(traffic["pool_batches"]):
        picks = [(a, b * traffic["per_aspect"] + j) for a in aspects for j in range(traffic["per_aspect"])]
        order = rng.permutation(len(picks))
        batches.append([by_aspect[picks[i][0]][picks[i][1]] for i in order])
    return batches


def face_counts(n: int, mean: float, cap: int) -> np.ndarray:
    """n face counts at the (i + 0.5) / n quantiles of a geometric law with
    the given mean, each in [1, cap]."""
    p = 1.0 / mean
    q = (np.arange(n) + 0.5) / n
    return np.clip(np.ceil(np.log1p(-q) / math.log1p(-p)), 1, cap).astype(int)


def face_rows(rng: np.random.Generator, size: int, n: int, scale: float, face_px, landmark_share: float) -> np.ndarray:
    """n [x1 y1 x2 y2, 5 x (lx, ly), flag] rows, normalized to a size x size
    crop: face heights log-uniform over face_px (source pixels) times
    `scale`, at most the crop less 2 px; landmarks inside the box with flag
    1, or -1 everywhere with flag -1."""
    lo, hi = np.log(face_px)
    side = np.minimum(np.exp(rng.uniform(lo, hi, n)) * scale, size - 2)
    bw = side * rng.uniform(0.8, 1.0, n)
    x1, y1 = rng.uniform(0, size - bw), rng.uniform(0, size - side)
    rows = np.zeros((n, 15), np.float32)
    rows[:, :4] = np.stack([x1, y1, x1 + bw, y1 + side], 1) / size
    u = rng.uniform(0.2, 0.8, (n, 5, 2))
    rows[:, 4:14] = (rows[:, None, :2] + u * (rows[:, None, 2:4] - rows[:, None, :2])).reshape(n, 10)
    flag = rng.random(n) < landmark_share
    rows[~flag, 4:14] = -1.0
    rows[:, 14] = np.where(flag, 1.0, -1.0)
    return rows


def train_pool(traffic: dict, seed: int, device) -> List[Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]]:
    """`pool_batches` device-resident training batches: mean-subtracted
    float32 images [B, S, S, 3] of smooth content, and padded targets
    (boxes [B, G, 4], labels [B, G], landmarks [B, G, 10], valid [B, G])
    with the same face counts in every batch and seed."""
    rng = numpy_rng(seed, 2)
    gen = torch_gen(seed, 2, device)
    bsz, size, g = traffic["batch"], traffic["image_size"], traffic["max_targets"]
    counts = face_counts(bsz, traffic["faces_per_image"], g)
    scale = size / traffic["source_width"]
    means = torch.tensor((104.0, 117.0, 123.0), device=device)
    pool = []
    for _ in range(traffic["pool_batches"]):
        images = smooth_images(gen, bsz, size, size, device).float() - means
        rows = np.zeros((bsz, g, 15), np.float32)
        valid = np.zeros((bsz, g), bool)
        for i, n in enumerate(rng.permutation(counts)):
            rows[i, :n] = face_rows(rng, size, int(n), scale, traffic["face_px"], traffic["landmark_share"])
            valid[i, :n] = True
        t = torch.from_numpy(rows).to(device)
        targets = (t[..., :4].contiguous(), t[..., 14].contiguous(), t[..., 4:14].contiguous(),
                   torch.from_numpy(valid).to(device))
        pool.append((images, targets))
    return pool


@torch.no_grad()
def seed_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Random weights in a few large draws on the model's device: conv
    weights N(0, 1/fan_in) (0.1 times that for the 1x1 heads, `conv1x1`,
    the non-local block's query and key, and every ECA's 1-D conv), conv
    biases N(0, 0.1^2), BatchNorm scale 1 + N(0, 0.1^2), shift 2 +
    N(0, 0.1^2), running mean N(0, 0.1^2), running variance U(0.5, 1.5).

    The shift of 2 and the small query and key keep the network smooth.
    With chip_smoke.py's zero shifts the seeded detector is chaotic: half a
    grey level of input noise moves its heads by 2 to 5 of their standard
    deviations, and bfloat16 rounding as much, so no comparison of
    precision could hold; a trained detector is smooth. With these, most
    units sit in the linear part of their activation and the attention
    logits stay of order one. The small ECA convs keep the channel gates
    inside (0, 1): at full scale a gate is 0 or 1 for most channels (57-61%
    of the FPN's outputs gated to 0), and on about one seed in 60 a whole
    tap is gated to 0, the FPN's ECA then takes the square root of a zero
    variance, and training's gradients (the served package's and the
    reference's alike) are NaN."""
    convs, biases, bns = [], [], []
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            small = name.endswith(("conv1x1", "f_query", "f_key", "conv1d"))
            std = m.weight[0].numel() ** -0.5 * (0.1 if small else 1.0)
            convs.append((m.weight, std))
            if m.bias is not None:
                biases.append(m.bias)
        elif isinstance(m, torch.nn.BatchNorm2d):
            bns.append(m)
    dev = convs[0][0].device
    normal = torch.randn(sum(w.numel() for w, _ in convs) + sum(b.numel() for b in biases)
                         + 3 * sum(m.num_features for m in bns), generator=gen, device=dev)
    uniform = torch.rand(sum(m.num_features for m in bns), generator=gen, device=dev)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return normal[at - n:at]

    for w, std in convs:
        w.copy_(std * take(w.numel()).view_as(w))
    for b in biases:
        b.copy_(0.1 * take(b.numel()))
    u = 0
    for m in bns:
        c = m.num_features
        m.weight.copy_(1.0 + 0.1 * take(c))
        m.bias.copy_(2.0 + 0.1 * take(c))
        m.running_mean.copy_(0.1 * take(c))
        m.running_var.copy_(0.5 + uniform[u:u + c])
        u += c


@torch.no_grad()
def calibrate_batchnorms(model: torch.nn.Module, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    its own input in one eval forward of NCHW `images`, so that each
    normalizes what reaches it (random statistics compound over residual
    blocks and saturate the heads). BatchNorms over 1x1 maps keep theirs."""
    def take(m, args):
        x = args[0].float()
        if x.shape[2] * x.shape[3] > 1:
            m.running_mean.copy_(x.mean((0, 2, 3)))
            m.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        model.eval()(images)
    finally:
        for h in hooks:
            h.remove()
