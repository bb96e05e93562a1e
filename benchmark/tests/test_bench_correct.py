"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the harness's look for a chip and drives the rest of a
run (set-up, window, check) on the CPU at the tiny sizes, with one fault
planted in the system after it is built: an answer altered where it is
produced, half of a batch left out (the other half's results given in its
place), and the chain's step returning its input unchanged. The tiny
configurations carry the real configurations' limits."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell  # noqa: E402
from benchmark.tests.tiny import make_tree, narrow_sr  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("tiny")
    return root, make_tree(root)


def _run(tree, workload, fault=None, trace=False):
    root, bench = tree
    with narrow_sr():
        res, table, _ = cell.run(workload, 2**31 + 5, 0.3, trace, time.perf_counter(),
                                 device="cpu", root=root, bench_dir=bench, fault=fault)
    return res


def _wrap_e2e(swapper, change):
    e2e = swapper._swap_e2e

    def broken(src, tgt, latent_avg):
        out = e2e(src, tgt, latent_avg)
        return (change(out[0], src, tgt, latent_avg, e2e),) + tuple(out[1:])

    swapper._swap_e2e = broken


def altered(swapper):
    def change(out, *_):
        out = out.clone()
        h = out.shape[-1] // 4
        out[:, :, h:3 * h, h:3 * h] = 255 - out[:, :, h:3 * h, h:3 * h]
        return out
    _wrap_e2e(swapper, change)


def half_batch(swapper):
    def change(out, src, tgt, latent_avg, e2e):
        h = src.shape[0] // 2
        first = e2e(src[:h], tgt[:h], latent_avg)[0]
        return torch.cat([first, first])
    _wrap_e2e(swapper, change)


def chain_unchanged(swapper):
    swapper.chain = lambda s_u8, t_u8: s_u8


@pytest.mark.parametrize("workload", ["swap.single", "swap.batch", "reenact.single",
                                      "reenact.batch"])
def test_sound_runs_are_correct(tree, workload):
    res = _run(tree, workload)
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("swap.single", altered), ("swap.batch", altered), ("reenact.single", altered),
    ("reenact.batch", altered), ("swap.batch", half_batch), ("reenact.batch", half_batch),
    ("reenact.single", chain_unchanged), ("reenact.batch", chain_unchanged)])
def test_a_broken_path_is_not_correct(tree, workload, fault):
    res = _run(tree, workload, fault)
    assert res["correct"] is False
    assert res["check"]["failed_calls"]["value"] == 0


def test_a_traced_run_judges_the_same(tree):
    assert _run(tree, "swap.batch", altered, trace=True)["correct"] is False


def test_a_non_finite_face_fails_the_call(tree):
    def nan_face(swapper):
        swapper.net.G.register_forward_hook(lambda m, i, out: (out[0] * float("nan"),)
                                            + tuple(out[1:]))
    res = _run(tree, "swap.single", nan_face)
    assert res["failed"] == res["attempted"] and res["correct"] is False
