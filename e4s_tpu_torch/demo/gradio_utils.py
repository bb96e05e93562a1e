"""The demo's region tables and its label-map <-> coloured-mask converters
(counterpart of ``demo/gradio_utils.py``); numpy only."""

from __future__ import annotations

import numpy as np

COMP = [
    "background", "lip", "eyebrows", "eyes", "hair", "nose", "skin", "ears",
    "belowface", "mouth", "eye_glass", "ear_rings",
]
COMP2INDEX = {name: i for i, name in enumerate(COMP)}

COMP_COLORS_NUMPY = np.array(
    [
        [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
        [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0],
        [255, 0, 0], [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204],
        [255, 51, 153], [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
    ]
)


def label_map_to_colored_mask(pred: np.ndarray) -> np.ndarray:
    """[H,W] labels (255: background) -> [H,W,3] uint8 colours."""
    h, w = np.shape(pred)
    rgb = np.zeros((h, w, 3), dtype=np.uint8)
    for ii in range(19):
        rgb[pred == ii] = COMP_COLORS_NUMPY[ii]
    rgb[pred == 255] = COMP_COLORS_NUMPY[0]
    return rgb


def colored_mask_to_label_map(colored_mask: np.ndarray) -> np.ndarray:
    """[H,W,3] colours -> [H,W] uint8 labels (unknown colours: 0)."""
    h, w = np.shape(colored_mask)[:2]
    label_map = np.zeros((h, w), dtype=np.uint8)
    for i in range(19):
        mm = np.sum(colored_mask == COMP_COLORS_NUMPY[i], axis=-1) == 3
        label_map[mm] = i
    return label_map
