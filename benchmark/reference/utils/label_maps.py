"""BiSeNet's (face-parsing.PyTorch) 19-class labels -> the detailed 12
classes, as a lookup table."""

from __future__ import annotations

# (19-class sources, 12-class target)
FFHQ19_PAIRS = [
    ([12, 13], 1), ([2, 3], 2), ([4, 5], 3), ([17], 4), ([10], 5),
    ([1], 6), ([7, 8], 7), ([14], 8), ([11], 9), ([6], 10), ([9], 11),
]


def lookup_table(pairs) -> list:
    """The pairs as a 19-entry table (unlisted classes -> 0)."""
    lut = [0] * 19
    for srcs, dst in pairs:
        for s in srcs:
            lut[s] = dst
    return lut
