"""The datasets and label helpers that the edit and inversion paths read
(counterpart of that subset of ``e4s_tpu/datasets/dataset.py``): host-side
numpy and PIL, NCHW float32 images in [-1,1] and [1,H,W] int32 label maps
in the detailed 12 classes.
"""

from __future__ import annotations

import os.path as osp
from typing import Callable

import numpy as np

from e4s_tpu_torch.utils.label_maps import celebahq_mask_to_faceparser_mask_detailed


def to_tensor(img) -> np.ndarray:
    """PIL or uint8 HWC -> float32 CHW in [0,1] (torchvision ToTensor)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return np.transpose(arr.astype(np.float32) / 255.0, (2, 0, 1))


def normalize_img(x: np.ndarray) -> np.ndarray:
    """Normalize((0.5,)*3, (0.5,)*3): [0,1] -> [-1,1]."""
    return x * 2.0 - 1.0


def label_map_to_onehot(label: np.ndarray, num_cls: int = 12) -> np.ndarray:
    """[B,1,H,W] int -> [B,num_cls,H,W] one-hot float32."""
    label = np.asarray(label)
    B, _, H, W = label.shape
    onehot = np.zeros((B, num_cls, H, W), dtype=np.float32)
    for c in range(num_cls):
        onehot[:, c] = (label[:, 0] == c).astype(np.float32)
    return onehot


class CelebAHQDataset:
    """CelebAMask-HQ: images 0-27999 train, 28000-29999 test, under
    ``CelebA-HQ-img/<i>.jpg`` with masks ``CelebA-HQ-mask/<i>.png``.
    ``__getitem__`` -> (image [3,H,W], label [1,H,W] int32, -1)."""

    def __init__(self, dataset_root: str, mode: str = "test",
                 fraction: float = 1.0,
                 label_converter: Callable = celebahq_mask_to_faceparser_mask_detailed,
                 normalize: bool = True):
        self.root = dataset_root
        self.label_converter = label_converter
        self.normalize = normalize
        rng = range(28000) if mode == "train" else range(28000, 30000)
        self.imgs = sorted(
            osp.join(self.root, "CelebA-HQ-img", "%d.jpg" % i) for i in rng)
        self.labels = sorted(
            osp.join(self.root, "CelebA-HQ-mask", "%d.png" % i) for i in rng)
        n = int(len(self.imgs) * fraction)
        self.imgs, self.labels = self.imgs[:n], self.labels[:n]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        from PIL import Image

        img = to_tensor(Image.open(self.imgs[idx]).convert("RGB"))
        if self.normalize:
            img = normalize_img(img)
        label = self.label_converter(
            np.asarray(Image.open(self.labels[idx]).convert("L")))
        return img, label[None].astype(np.int32), -1


class SyntheticFaceDataset:
    """Deterministic synthetic (image, mask) pairs, the JAX package's
    stand-in when no CelebAMask-HQ tree is mounted: uniform noise in [-1,1]
    under a disc of skin with a nose, hair above and a lip band."""

    def __init__(self, size: int = 1024, num_seg_cls: int = 12, length: int = 64):
        self.size = size
        self.num_seg_cls = num_seg_cls
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(3, self.size, self.size).astype(np.float32) * 2 - 1
        yy, xx = np.mgrid[0:self.size, 0:self.size]
        cx = self.size / 2 + (idx % 7 - 3) * self.size / 32
        r = np.hypot(yy - self.size / 2, xx - cx)
        label = np.zeros((self.size, self.size), dtype=np.int32)
        label[r < self.size * 0.38] = 6  # skin
        label[r < self.size * 0.1] = 5  # nose
        label[(yy < self.size * 0.35) & (r < self.size * 0.45)] = 4  # hair
        label[(np.abs(yy - self.size * 0.62) < self.size * 0.02)
              & (r < self.size * 0.2)] = 1  # lip
        return img, label[None], -1
