"""Image conversions and label-map colouring on the host (counterpart of
``e4s_tpu/utils/img_utils.py``)."""

from __future__ import annotations

from typing import List

import numpy as np


def tensor2im(var: np.ndarray):
    """[3,H,W] in [-1,1] -> PIL RGB (truncating uint8 cast)."""
    from PIL import Image

    arr = np.transpose(np.asarray(var), (1, 2, 0))
    arr = np.clip((arr + 1) / 2, 0, 1) * 255
    return Image.fromarray(arr.astype("uint8"))


def get_colors() -> List[List[int]]:
    """One RGB colour per label (19)."""
    return [
        [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
        [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0],
        [255, 0, 0], [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204],
        [255, 51, 153], [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
    ]


def vis_mask_in_color(mask: np.ndarray) -> np.ndarray:
    """[H,W] labels -> [H,W,3] uint8 colours."""
    colors = get_colors()
    out = np.ones(mask.shape + (3,))
    for class_idx in np.unique(mask):
        out[mask == class_idx] = colors[class_idx]
    return out.astype("uint8")
