"""Image conversions, label-map colouring, loss averaging and the training
log's face grids (counterpart of ``e4s_tpu/utils/img_utils.py``); only
``im2tensor`` and ``label_map_to_onehot`` make tensors, the rest work on the
host. matplotlib is imported only by ``vis_faces``."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def tensor2im(var: np.ndarray):
    """[3,H,W] in [-1,1] -> PIL RGB (truncating uint8 cast)."""
    from PIL import Image

    arr = np.transpose(np.asarray(var), (1, 2, 0))
    arr = np.clip((arr + 1) / 2, 0, 1) * 255
    return Image.fromarray(arr.astype("uint8"))


def im2tensor(img) -> torch.Tensor:
    """PIL RGB (or an [H,W,3] uint8 array) -> [3,H,W] float32 in [-1,1]."""
    arr = torch.from_numpy(np.asarray(img, np.float32) / 255.0)
    return arr.permute(2, 0, 1) * 2 - 1


def label_map_to_onehot(label: torch.Tensor, num_cls: int = 12) -> torch.Tensor:
    """[B,1,H,W] integer labels -> [B,num_cls,H,W] float32 one-hot, on the
    labels' device."""
    classes = torch.arange(num_cls, device=label.device).reshape(1, num_cls, 1, 1)
    return (label == classes).float()


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


def tensor2map(var: np.ndarray):
    """[C,H,W] one-hot or logits -> the coloured argmax as PIL RGB."""
    from PIL import Image

    return Image.fromarray(vis_mask_in_color(np.argmax(np.asarray(var), axis=0)))


def aggregate_loss_dict(agg_loss_dict: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The mean of each key over a list of loss dicts."""
    vals: Dict[str, list] = {}
    for output in agg_loss_dict:
        for key, value in output.items():
            vals.setdefault(key, []).append(value)
    return {k: sum(v) / len(v) for k, v in vals.items()}


def vis_faces(log_hooks: Sequence[Dict]):
    """A matplotlib figure with one row per dict: its ``input_face``,
    ``input_mask`` and ``recon_styleCode`` images."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 4 * len(log_hooks)))
    gs = fig.add_gridspec(len(log_hooks), 3)
    for i, hooks in enumerate(log_hooks):
        for j, key in enumerate(("input_face", "input_mask", "recon_styleCode")):
            ax = fig.add_subplot(gs[i, j])
            ax.imshow(hooks[key])
            ax.set_title(key)
            ax.axis("off")
    plt.tight_layout()
    return fig
