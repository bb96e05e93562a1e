"""The plain reference against ``e4s_tpu_torch`` on the CPU at small sizes,
the same seeded weights handed to both (``systems/e4s_swap.py`` gives the
port the reference's). Run by hand, not collected by ``pytest tests/``."""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.manifest import system_module  # noqa: E402
from benchmark.reference.build import build_chain, build_models, latent_avg  # noqa: E402
from benchmark.reference.pipelines.swap_core import swap_e2e  # noqa: E402
from benchmark.tests.tiny import S, config, narrow_sr  # noqa: E402

SEED = 2**31 + 99


def _pairs(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (n, 3, S, S), generator=g, dtype=torch.uint8),
            torch.randint(0, 256, (n, 3, S, S), generator=g, dtype=torch.uint8))


@functools.lru_cache(maxsize=None)
def _built(chain: bool):
    torch.set_num_threads(4)
    cfg = config("t", chain)
    with narrow_sr():
        swapper, checksum = system_module(cfg).build(cfg, SEED, "cpu")
    models = build_models(cfg, SEED, "cpu")
    return cfg, swapper, models, checksum


@pytest.fixture(params=[False, True], ids=["swap", "reenact"])
def both(request):
    return _built(request.param)


def test_the_port_got_the_references_weights(both):
    cfg, swapper, models, checksum = both
    assert system_module(cfg).weights_checksum(models) == checksum
    for k, v in models["net3"].state_dict().items():
        assert torch.equal(swapper.net.state_dict()[k], v), k


def test_fused_swap_matches(both):
    cfg, swapper, models, _ = both
    s, t = _pairs(3)
    with torch.no_grad():
        got, s_lab, _, _, _ = swapper._swap_e2e(s, t, swapper.latent_avg)
        ref, r_lab = swap_e2e(models["net3"], models["parser"], s, t,
                              latent_avg(cfg, "cpu"), cfg["parser"]["parser_size"])
    assert torch.equal(s_lab, r_lab)
    assert (got.int() - ref.int()).abs().max() <= 1


def test_chain_matches():
    cfg, swapper, models, _ = _built(True)
    chain = build_chain(cfg, models)
    s, t = _pairs(2, seed=1)
    for i in range(2):
        with torch.no_grad():
            got = swapper.chain(s[i:i + 1], t[i:i + 1])
            ref = chain(s[i:i + 1], t[i:i + 1])
        assert got.shape == ref.shape == (1, 3, S, S)
        assert (got.int() - ref.int()).abs().max() <= 1


def test_masked_conv_region_loop_matches_the_ports_per_pixel_form():
    from benchmark.reference.ops.modconv import masked_modulated_conv2d_naive
    from e4s_tpu_torch.ops.modconv import masked_modulated_conv2d

    g = torch.Generator().manual_seed(3)
    for up, (Ci, Co, H) in [(False, (16, 24, 8)), (True, (16, 8, 8))]:
        x = torch.randn((2, Ci, H, H), generator=g)
        w = torch.randn((Co, Ci, 3, 3), generator=g) / 12
        s = torch.randn((2, 12, Ci), generator=g) + 1
        lab = torch.randint(0, 12, (2, 1, 16, 16), generator=g)
        mask = (lab == torch.arange(12)[None, :, None, None]).float()
        got = masked_modulated_conv2d(x.contiguous(memory_format=torch.channels_last),
                                      w, s, mask, up=up)
        ref = masked_modulated_conv2d_naive(x, w, s, mask, up=up)
        assert torch.allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_reference_swap_sees_the_source():
    """Another source changes the reference's result (the comparison is
    not blind to the face that is swapped in)."""
    cfg = config("t", False)
    models = build_models(cfg, SEED, "cpu")
    s, t = _pairs(1)
    s2, _ = _pairs(1, seed=5)
    with torch.no_grad():
        a, _ = swap_e2e(models["net3"], models["parser"], s, t, latent_avg(cfg, "cpu"), S)
        b, _ = swap_e2e(models["net3"], models["parser"], s2, t, latent_avg(cfg, "cpu"), S)
    assert not np.array_equal(a.numpy(), b.numpy())
