"""The metrics' arithmetic on synthetic inputs, and the counts the
configurations keep against a recomputation. Run by hand:
``python -m pytest benchmark/tests -q`` (the FLOP recounts run the
reference at full size, on a card only)."""

import json
import random
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import stats  # noqa: E402
from benchmark.harness.trace import WINDOW, Event, reduce_events  # noqa: E402

CONFIGS = sorted((ROOT / "benchmark" / "configs").glob("*.json"))


def _config(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_numpy(q):
    rng = np.random.default_rng(q)
    for n in (1, 2, 7, 100, 333):
        xs = rng.exponential(size=n).tolist()
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def test_rate_and_spread():
    assert stats.rate(120, 30.0) == 4.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps_against_a_grid():
    rnd = random.Random(0)
    for _ in range(50):
        iv = []
        for _ in range(rnd.randint(0, 12)):
            a = rnd.randint(0, 90)
            iv.append((a, a + rnd.randint(0, 15)))
        lo, hi = 5, 95
        grid = [t for t in range(lo, hi) if any(a <= t < b for a, b in iv)]
        assert stats.union_length(iv, lo, hi) == len(grid)
        idle = sum(b - a for a, b in stats.gaps(iv, lo, hi))
        assert idle + stats.union_length(iv, lo, hi) == hi - lo


def test_roofline_and_mfu_arithmetic():
    launches = [{"H": 64, "Ci": 512, "Co": 512, "up": False},
                {"H": 4, "Ci": 512, "Co": 512, "up": True}]
    f0, b0 = stats.masked_conv_cost(64, 512, 512, False)
    f1, b1 = stats.masked_conv_cost(4, 512, 512, True)
    least = max(f0 / 495e12, b0 / 3.35e12) + max(f1 / 495e12, b1 / 3.35e12)
    assert stats.least_time_s(launches) == pytest.approx(least)
    assert stats.roofline_pct(least, 4 * least) == pytest.approx(25.0)
    assert stats.roofline_pct(least, 0.0) is None
    assert stats.mfu_pct(1e12, 10, 2.0) == pytest.approx(100 * 1e13 / (2.0 * 495e12))
    assert stats.mfu_pct(1e12, 0, 2.0) is None


def _conv_flops(x_shape, w_shape, up):
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(x_shape, device="meta")
    with FlopCounterMode(display=False) as fc:
        if up:  # the layer's transposed conv, one weight [Ci,Co,3,3]
            w = torch.empty((w_shape[1], w_shape[0], 3, 3), device="meta")
            torch.nn.functional.conv_transpose2d(x, w, stride=2)
        else:
            torch.nn.functional.conv2d(x, torch.empty(w_shape, device="meta"), padding=1)
    return fc.get_total_flops()


@pytest.mark.parametrize("B", [1, 8])
def test_masked_conv_cost_against_a_recount(B):
    """FLOPs: the layer's one conv (a stride-2 transposed conv for an up
    layer), counted by FlopCounterMode; bytes: x, the output, the weight
    once, the 12 regions' styles and demodulation, a byte per output
    pixel."""
    for H, Ci, Co, up in [(16, 512, 512, False), (64, 512, 256, True)]:
        s = 2 if up else 1
        flops = _conv_flops((B, Ci, H, H), (Co, Ci, 3, 3), up)
        tensors = [(B, H, H, Ci), (B, s * H, s * H, Co), (Co, Ci, 3, 3), (B, 12, Ci),
                   (B, 12, Co)]
        nbytes = 4 * sum(int(np.prod(t)) for t in tensors) + B * s * s * H * H
        assert stats.masked_conv_cost(H, Ci, Co, up, B) == (flops, nbytes)


def test_an_up_layer_costs_no_more_than_its_function():
    """An up layer's least time does not count the port's four polyphase
    weights: its FLOPs are those of the same layer without the upsampling."""
    f_up, _ = stats.masked_conv_cost(32, 512, 256, True)
    f_same, _ = stats.masked_conv_cost(32, 512, 256, False)
    assert f_up == f_same


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_launch_shapes_are_the_ports(path):
    """The 13 launch shapes a configuration keeps are those the port's
    Generator passes to ``masked_modulated_conv2d`` at its sizes."""
    import e4s_tpu_torch.models.stylegan2 as sg
    from e4s_tpu_torch.pipelines.model_io import materialise

    c = _config(path)
    n = c["net3"]
    seen = []

    def record(x, w_scaled, s, mask, *, up=False, **kw):
        B, Ci, H, _ = x.shape
        seen.append({"H": H, "Ci": Ci, "Co": w_scaled.shape[0], "up": up})
        f = 2 if up else 1
        return torch.zeros((B, w_scaled.shape[0], f * H, f * H)).contiguous(
            memory_format=torch.channels_last)

    G = materialise(lambda: sg.Generator(n["out_size"], n["style_dim"], n["n_mlp"],
                                         n["channel_multiplier"],
                                         remaining_layer_idx=n["remaining_layer_idx"],
                                         ch_div=n["ch_div"]), None, 0, "cpu")
    R = n["num_seg_cls"]
    latent = torch.zeros((1, R, n["n_styles"], n["style_dim"]))
    mask = torch.zeros((1, R, 32, 32))
    mask[:, 0] = 1
    old = sg.masked_modulated_conv2d
    sg.masked_modulated_conv2d = record
    try:
        with torch.no_grad():
            G([latent], None, mask, input_is_latent=True, randomize_noise=False)
    finally:
        sg.masked_modulated_conv2d = old
    assert seen == c["masked_conv"]["launches"]


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_flops_per_image_against_a_recount(path):
    from benchmark.harness.manifest import system_module

    if not torch.cuda.is_available():
        pytest.skip("the recount runs the reference at full size, on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c = _config(path)
    with torch.no_grad():
        assert system_module(c).count_flops(c, "cuda") == c["flops_per_image"]


def _ev(kind, name, a, b, corr=0, linked=0, ident=0):
    return Event(kind, name, a, b, corr=corr, linked=linked, ident=ident)


def test_trace_reduction_on_synthetic_events():
    """Kernels are attributed to spans by where they were launched, busy
    time is the union inside the window, gaps take the innermost span."""
    ev = [
        _ev("range", WINDOW, 0, 1000),
        _ev("range", "swap_e2e", 100, 600),
        _ev("range", "encoder", 120, 300),
        _ev("runtime", "cudaLaunchKernel", 130, 135, corr=1),
        _ev("runtime", "cudaLaunchKernel", 310, 315, corr=2),
        _ev("runtime", "cudaLaunchKernel", 700, 705, corr=3),
        _ev("device", "k_conv", 140, 400, corr=1),  # launched in encoder
        _ev("device", "k_other", 400, 450, corr=2),  # in swap_e2e only
        _ev("device", "k_late", 710, 760, corr=3),  # in no span
        _ev("device", "k_linked", 800, 820, corr=9, linked=77),
        _ev("range", "aten::op", 790, 795, ident=77),
        _ev("device", "encoder", 140, 400),  # the span's own device range
        _ev("device", "k_before", -50, 10, corr=0),
    ]
    r = reduce_events(ev, ["swap_e2e", "encoder"])
    assert r.window_s == pytest.approx(1000e-9)
    busy = 10 + (450 - 140) + 50 + 20
    assert r.busy_s == pytest.approx(busy * 1e-9)
    assert r.span_calls == {"swap_e2e": 1, "encoder": 1}
    assert r.span_device_s["encoder"] == pytest.approx(260e-9)
    assert r.span_device_s["swap_e2e"] == pytest.approx(310e-9)
    assert dict((k, v) for k, v in r.device_ops)["k_conv"] == pytest.approx(260e-9)
    gaps = dict((k, v) for k, v in r.idle_gaps)
    # idle 10..140 (encoder from 120), 450..710 (swap_e2e until 600),
    # 760..800 and 820..1000
    assert gaps == pytest.approx({"outside spans": (90 + 110 + 40 + 180) * 1e-9,
                                  "swap_e2e": (120 - 100 + 600 - 450) * 1e-9,
                                  "encoder": 20e-9})
