"""The arithmetic of the metrics: percentiles, rates, the union of device
intervals, roofline shares and the whole step's share of the peak.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity). The f32 cells run with TF32 off, and no implementation that keeps
f32 accuracy beats the dense TF32 rate, so their shares are taken against
it, each operation counted once.
"""

from __future__ import annotations

import math
import statistics

PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between closest ranks (numpy's default): every value
    counts, none is dropped."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Items per second over a span of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals, lo=None, hi=None) -> float:
    """Total length covered by the union of (start, end) ``intervals``,
    each clipped to [lo, hi] when given."""
    spans = []
    for a, b in intervals:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            spans.append((a, b))
    spans.sort()
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] that no interval covers, as
    (start, end) pairs in time order."""
    out, t = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def masked_conv_cost(H, Ci, Co, up, B=1, itemsize=4, regions=12):
    """FLOPs and bytes of the work of one region-masked modulated 3x3 conv
    layer at batch B, counted from what the layer computes and not from
    any implementation of it. FLOPs: each input pixel meets each of the 9
    taps once, for every input and output channel; an up layer is a
    stride-2 transposed 3x3 conv, whose count is the same, and its 4x4 blur
    (per channel, under 6% of the products at these widths) is left out.
    Bytes: x, the output (at 2H for up) and the weight once, each
    ``itemsize`` bytes, the regions' styles and demodulation factors, and
    one byte per output pixel for its region."""
    s = 2 if up else 1
    flops = 2.0 * B * H * H * Ci * Co * 9
    nbytes = (itemsize * (B * H * H * Ci + B * s * s * H * H * Co + 9 * Ci * Co
                          + B * regions * (Ci + Co))
              + B * s * s * H * H)
    return flops, nbytes


def least_time_s(launches, B=1, peak_flops=PEAK_TF32_FLOPS,
                 peak_bytes=PEAK_HBM_BYTES, itemsize=4, regions=12) -> float:
    """The least time the card could take for ``launches`` (dicts with H,
    Ci, Co, up) run one after another at batch B: per layer the larger of
    its FLOPs over the peak rate and its bytes over HBM bandwidth, summed."""
    total = 0.0
    for L in launches:
        f, b = masked_conv_cost(L["H"], L["Ci"], L["Co"], L["up"], B, itemsize, regions)
        total += max(f / peak_flops, b / peak_bytes)
    return total


def roofline_pct(least_s: float, device_s: float):
    """The least time as a share of the measured device time, in %; None
    where nothing was measured."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s


def mfu_pct(flops_per_image: float, images: float, window_s: float,
            peak_flops=PEAK_TF32_FLOPS):
    """The whole step's share of the peak over a window, in %."""
    if window_s <= 0 or images <= 0:
        return None
    return 100.0 * flops_per_image * images / (window_s * peak_flops)
