"""The datasets, the batch loader and the label helpers (counterpart of
``e4s_tpu/datasets/dataset.py``, without its native C++ decode path):
host-side numpy and PIL, NCHW float32 images in [-1,1] and [1,H,W] int32
label maps in the detailed 12 classes.
"""

from __future__ import annotations

import os.path as osp
import queue as queue_mod
import random
import threading
from typing import Callable

import numpy as np

from e4s_tpu_torch.utils.label_maps import (
    celebahq_mask_to_faceparser_mask_detailed,
    ffhq_mask_to_faceparser_mask_detailed,
)


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


def _flip(img, label, flip_p):
    """Both mirrored left-right with probability ``flip_p`` (Python's
    ``random``, as the JAX package draws it)."""
    if flip_p > 0 and random.random() < flip_p:
        return img[:, :, ::-1].copy(), label[:, :, ::-1].copy()
    return img, label


class CelebAHQDataset:
    """CelebAMask-HQ: images 0-27999 train, 28000-29999 test, under
    ``CelebA-HQ-img/<i>.jpg`` with masks ``CelebA-HQ-mask/<i>.png``.
    ``__getitem__`` -> (image [3,H,W], label [1,H,W] int32, -1), both
    mirrored with probability ``flip_p``."""

    def __init__(self, dataset_root: str, mode: str = "test",
                 fraction: float = 1.0, flip_p: float = -1.0,
                 label_converter: Callable = celebahq_mask_to_faceparser_mask_detailed,
                 normalize: bool = True):
        self.root = dataset_root
        self.flip_p = flip_p
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
        img, label = _flip(img, label[None].astype(np.int32), self.flip_p)
        return img, label, -1


class FFHQDataset:
    """FFHQ at 1024^2: the images listed in ``images_1024/ffhq_list.txt``
    (sorted) with BiSeNet masks under ``BiSeNet_mask/`` in
    face-parsing.PyTorch's 19 classes. ``__getitem__`` as
    ``CelebAHQDataset``'s."""

    def __init__(self, dataset_root: str, fraction: float = 1.0,
                 flip_p: float = -1.0,
                 label_converter: Callable = ffhq_mask_to_faceparser_mask_detailed,
                 normalize: bool = True):
        self.root = dataset_root
        self.flip_p = flip_p
        self.label_converter = label_converter
        self.normalize = normalize
        with open(osp.join(self.root, "images_1024", "ffhq_list.txt")) as f:
            lines = [line.strip() for line in f if line.strip()]
        self.imgs = sorted(osp.join(self.root, "images_1024", n) for n in lines)
        self.imgs = self.imgs[: int(len(self.imgs) * fraction)]
        self.labels = [p.replace("images_1024", "BiSeNet_mask") for p in self.imgs]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        from PIL import Image

        img = to_tensor(Image.open(self.imgs[idx]).convert("RGB"))
        if self.normalize:
            img = normalize_img(img)
        label = self.label_converter(
            np.asarray(Image.open(self.labels[idx]).convert("L")))
        img, label = _flip(img, label[None].astype(np.int32), self.flip_p)
        return img, label, -1


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


class DataLoader:
    """Batches (image [B,3,H,W], label [B,1,H,W], one-hot [B,R,H,W]) as
    numpy, assembled on a background thread (``num_prefetch`` ahead).

    With ``shuffle`` each epoch's order is a permutation drawn from
    ``seed + epoch`` alone, the same in every process. ``num_shards`` /
    ``shard_index`` then give this process a stride of it, the list first
    padded by wrapping to a multiple of ``num_shards``, so that every
    process sees as many batches (``DistributedSampler``'s rule)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_prefetch: int = 2,
                 num_seg_cls: int = 12, num_shards: int = 1, shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_prefetch = num_prefetch
        self.num_seg_cls = num_seg_cls
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def _shard_len(self):
        return -(-len(self.dataset) // self.num_shards)

    def __len__(self):
        n, rest = divmod(self._shard_len(), self.batch_size)
        return n + (1 if rest and not self.drop_last else 0)

    def _assemble(self, indices):
        items = [self.dataset[i] for i in indices]
        img = np.stack([it[0] for it in items])
        label = np.stack([it[1] for it in items])
        return img, label, label_map_to_onehot(label, self.num_seg_cls)

    def _batches(self):
        """This epoch's batches of dataset indices (advances the epoch)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.num_shards > 1:
            pad = self._shard_len() * self.num_shards - len(order)
            order = np.concatenate([order, order[:pad]])[self.shard_index::self.num_shards]
        self.epoch += 1
        stop = len(order) - (self.batch_size - 1 if self.drop_last else 0)
        return [order[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self):
        batches = self._batches()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.num_prefetch)
        done = object()

        def worker():
            for b in batches:
                q.put(self._assemble(b))
            q.put(done)

        threading.Thread(target=worker, daemon=True).start()
        while (item := q.get()) is not done:
            yield item
