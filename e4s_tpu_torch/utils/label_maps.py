"""19-class parser labels -> the detailed 12 classes or the 9, on the host
(counterparts of the four mask converters of
``e4s_tpu/datasets/dataset.py``). The two 19-class taxonomies order their
classes differently: BiSeNet (face-parsing.PyTorch) is "ffhq19", SegNeXt and
the CelebAMask-HQ masks are "celeba19".
"""

from __future__ import annotations

import numpy as np

# (19-class sources, 12-class target) of each taxonomy
FFHQ19_PAIRS = [
    ([12, 13], 1), ([2, 3], 2), ([4, 5], 3), ([17], 4), ([10], 5),
    ([1], 6), ([7, 8], 7), ([14], 8), ([11], 9), ([6], 10), ([9], 11),
]
CELEBA19_PAIRS = [
    ([11, 12], 1), ([6, 7], 2), ([4, 5], 3), ([13], 4), ([2], 5),
    ([1], 6), ([8, 9], 7), ([17], 8), ([10], 9), ([3], 10), ([15], 11),
]
# the same to the 9 classes (lip and mouth merged; no glasses, no ear rings)
FFHQ19_PAIRS_9 = [
    ([11, 12, 13], 1), ([2, 3], 2), ([4, 5], 3), ([17], 4), ([10], 5),
    ([1], 6), ([7, 8], 7), ([14], 8),
]
CELEBA19_PAIRS_9 = [
    ([10, 11, 12], 1), ([6, 7], 2), ([4, 5], 3), ([13], 4), ([2], 5),
    ([1], 6), ([8, 9], 7), ([17], 8),
]


def lookup_table(pairs) -> list:
    """The pairs as a 19-entry table (unlisted classes -> 0)."""
    lut = [0] * 19
    for srcs, dst in pairs:
        for s in srcs:
            lut[s] = dst
    return lut


def _remap(mask: np.ndarray, pairs) -> np.ndarray:
    out = np.zeros_like(mask)
    for sources, target in pairs:
        out[np.isin(mask, sources)] = target
    return out


def ffhq_mask_to_faceparser_mask_detailed(mask: np.ndarray) -> np.ndarray:
    """face-parsing.PyTorch 19 classes -> the detailed 12."""
    return _remap(np.asarray(mask), FFHQ19_PAIRS)


def celebahq_mask_to_faceparser_mask_detailed(mask: np.ndarray) -> np.ndarray:
    """CelebAMask-HQ 19 classes -> the detailed 12."""
    return _remap(np.asarray(mask), CELEBA19_PAIRS)


def ffhq_mask_to_faceparser_mask(mask: np.ndarray) -> np.ndarray:
    """face-parsing.PyTorch 19 classes -> the 9."""
    return _remap(np.asarray(mask), FFHQ19_PAIRS_9)


def celebahq_mask_to_faceparser_mask(mask: np.ndarray) -> np.ndarray:
    """CelebAMask-HQ 19 classes -> the 9."""
    return _remap(np.asarray(mask), CELEBA19_PAIRS_9)
