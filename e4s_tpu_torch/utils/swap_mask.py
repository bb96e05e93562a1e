"""Mask and texture swap on the host, in numpy (counterpart of
``e4s_tpu/utils/swap_mask.py``). The staged swap path takes these; the fused
path has their device twins in ``pipelines/swap_core.py``.
"""

from __future__ import annotations

import numpy as np

PLACEHOLDER = 99  # marks the target's background while the source is laid in


def swap_head_mask(source: np.ndarray, target: np.ndarray, hair_first: bool = True):
    """Swapped 12-class map: the target keeps background, neck, ears,
    earrings, hair and glasses; the source gives lip, brows, eyes, nose, skin
    and mouth where the target is not background; holes become skin.
    Returns (swapped map, hole map with 255 at the holes)."""
    source = np.asarray(source)
    target = np.asarray(target)
    res = np.zeros_like(target)
    res[target == 0] = PLACEHOLDER
    for cls in (8, 7, 11):  # neck, ear, earrings
        res[target == cls] = cls
    if hair_first:
        res[target == 4] = 4
    for cls in (1, 2, 3, 5, 6, 9):  # lip, brows, eyes, nose, skin, mouth
        res[(source == cls) & (res != PLACEHOLDER)] = cls
    if not hair_first:
        res[target == 4] = 4
    res[target == 10] = 10  # the target's glasses
    if np.sum(res == 0) != 0:
        hole_map = 255 * (res == 0).astype(res.dtype)
        res[res == 0] = 6
    else:
        hole_map = np.zeros_like(res)
    res[res == PLACEHOLDER] = 0
    return res, hole_map


def swap_comp_style_vector(style_vectors1, style_vectors2, comp_indices,
                           belowface_interpolation=False):
    """Region-wise texture swap [1,R,F]: regions ``comp_indices`` from
    ``style_vectors2`` (source), the rest from ``style_vectors1`` (target);
    an absent source ear (7) averages both, an absent source mouth (9) keeps
    the target's."""
    style_vectors = np.array(style_vectors1, copy=True)
    for comp_idx in comp_indices:
        style_vectors[:, comp_idx, :] = style_vectors2[:, comp_idx, :]
    if np.sum(style_vectors2[:, 7, :]) == 0:
        style_vectors[:, 7, :] = (style_vectors1[:, 7, :] + style_vectors2[:, 7, :]) / 2
    if np.sum(style_vectors2[:, 9, :]) == 0:
        style_vectors[:, 9, :] = style_vectors1[:, 9, :]
    if belowface_interpolation:
        style_vectors[:, 8, :] = (style_vectors1[:, 8, :] + style_vectors2[:, 8, :]) / 2
    return style_vectors
