"""The one generator of input pairs; a traffic mix is a data file of its
parameters (``traffic/<mix>.json``).

A pool of ``pool`` distinct (source, target) pairs is drawn from the seed:
each face is one of ``faces`` (two different faces per pair), resized to the
configuration's side, flipped with probability ``flip``, scaled by a factor
in ``scale`` about its centre and shifted by up to ``shift_px`` pixels, and
jittered in brightness, contrast and saturation by up to ``jitter``; the
images are made on the device in a few batched calls. Every
seed gives pairs of the same size and count; only their content differs.
How the pairs become calls is the mix's entry point's
(``entries/<entry>.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _faces(mix: dict, size: int, bench_dir: Path) -> np.ndarray:
    """The mix's faces decoded and resized to ``size``: uint8 [F,3,S,S]."""
    from PIL import Image

    return np.stack([to_chw_u8(Image.open(bench_dir / "traffic" / f).convert("RGB")
                               .resize((size, size))) for f in mix["faces"]])


def _params(mix: dict, rng, n_faces: int):
    """Per image of each pair: face index, flip, scale, shift (dx, dy) and
    the brightness, contrast and saturation factors."""
    out = []
    for _ in range(mix["pool"]):
        pair = rng.choice(n_faces, size=2, replace=False)
        for face in pair:
            flip = rng.random() < mix["flip"]
            s = rng.uniform(*mix["scale"])
            dx, dy = rng.integers(-mix["shift_px"], mix["shift_px"] + 1, size=2)
            j = mix["jitter"]
            out.append((int(face), flip, s, int(dx), int(dy),
                        *rng.uniform(1 - j, 1 + j, size=3)))
    return out


def _augment(faces, params, size: int, device):
    """The images of ``params`` as uint8 [n,3,S,S], made on ``device``:
    flip, then scale about the centre and shift (bilinear, mid-grey
    outside), then brightness, contrast (about the mean luma) and
    saturation (about the luma)."""
    import torch
    import torch.nn.functional as F

    base = torch.from_numpy(faces).to(device).float() / 255.0
    idx = torch.tensor([p[0] for p in params], device=device)
    flip = torch.tensor([p[1] for p in params], device=device)
    s, dx, dy, fb, fc, fs = (torch.tensor([p[k] for p in params], dtype=torch.float32,
                                          device=device) for k in range(2, 8))
    img = base[idx]
    img = torch.where(flip[:, None, None, None], img.flip(-1), img)
    theta = torch.zeros((len(params), 2, 3), device=device)
    theta[:, 0, 0] = theta[:, 1, 1] = 1.0 / s
    theta[:, 0, 2] = -2.0 * dx / (size * s)
    theta[:, 1, 2] = -2.0 * dy / (size * s)
    grid = F.affine_grid(theta, list(img.shape), align_corners=False)
    grey = 127.0 / 255.0
    img = F.grid_sample(img - grey, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False) + grey
    img = img * fb[:, None, None, None]
    luma = (img * torch.tensor([0.299, 0.587, 0.114], device=device)[None, :, None, None]
            ).sum(1, keepdim=True)
    mean = luma.mean(dim=(1, 2, 3), keepdim=True)
    img = mean + fc[:, None, None, None] * (img - mean)
    luma = (img * torch.tensor([0.299, 0.587, 0.114], device=device)[None, :, None, None]
            ).sum(1, keepdim=True)
    img = luma + fs[:, None, None, None] * (img - luma)
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def make_pool(mix: dict, size: int, seed: int, bench_dir: Path, device="cpu"):
    """The mix's pairs: uint8 source and target arrays [pool,3,S,S], made
    on ``device`` in blocks of 16 images."""
    rng = np.random.default_rng([int(seed), 0])
    faces = _faces(mix, size, bench_dir)
    params = _params(mix, rng, len(faces))
    imgs = np.concatenate([_augment(faces, params[k:k + 16], size, device)
                           for k in range(0, len(params), 16)])
    return imgs[0::2], imgs[1::2]


def to_chw_u8(img) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img, np.uint8).transpose(2, 0, 1))
