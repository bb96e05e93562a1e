"""Data-parallel training of the port on the CPU: two processes in a gloo
group (``DistributedDataParallel`` around Net3 and D, the loader's shard
from the rank) take one D step, one R1 step and one G step, each on its
shard of 4 of the first shuffled batch of 8. Against the same three steps
in one process on all 8 (the shards interleave, so D's minibatch groups of
4 are the same samples in both):

- both ranks end with identical parameters and gradients;
- their gradients (Net3's of the G step, D's of the R1 step) equal the one
  process's: 1e-4 relative per tensor (sums in another order);
- their parameters equal the one process's to one Adam step's rounding.

Each process has a join timeout, so that nothing can hang the suite.
"""

import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests.torch_port_helpers import rel_err, torch_threads

from e4s_tpu_torch.datasets.dataset import SyntheticFaceDataset
from e4s_tpu_torch.training.coach import Coach

S, WORLD, BATCH = 16, 2, 8
JOIN_TIMEOUT_S = 240


def _opts(tmp, batch_size):
    import types

    return types.SimpleNamespace(
        exp_dir=str(tmp), device="cpu", num_seg_cls=12, out_size=S,
        remaining_layer_idx=5, n_styles=6, encoder_size=32, encoder_slim=True,
        ch_div=8, start_from_latent_avg=True, train_G=True, train_D=True,
        learning_rate=1e-4, optim_name="adam", d_reg_every=1, d_every=1,
        max_steps=0, board_interval=1, image_interval=0, val_interval=1000,
        save_interval=1000, seed=0, bf16=False, dataset_name="synthetic",
        batch_size=batch_size, latent_avg_samples=16, lpips_lambda=0.8,
        id_lambda=0.0, id_loss_multiscale=True, face_parsing_lambda=0.0,
        l2_lambda=1.0, w_norm_lambda=0.01, r1_lambda=10.0, g_adv_lambda=0.01,
        style_lambda=0.0, style_loss_norm=1, stylegan_weights=None,
        checkpoint_path=None, ir_se50_path=None, face_parsing_model_path=None,
        tensorboard=False)


def _steps(coach):
    """D, R1 and G steps on the first batch of the Coach's own train loader,
    noise fixed to the registered maps; returns the parameters and the last
    gradients (Net3's from the G step, D's from the R1 step)."""
    train_loader, _ = coach.configure_datasets()
    img, label, onehot = coach._to_device(next(iter(train_loader)))
    G = coach.net.G
    noise = [getattr(G.noises, f"noise_{i}") for i in range(G.num_layers)]
    coach._d_step(img, onehot, noise=noise)
    coach._d_r1_step(img)
    coach._g_step(img, label, onehot, noise=noise)

    def grads(m):
        return {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}

    return {"net": coach.net.state_dict(), "D": coach.D.state_dict(),
            "net_grads": grads(coach.net), "d_grads": grads(coach.D),
            "shard": (train_loader.shard_index, train_loader.num_shards)}


def _rank_main(rank, port, tmp):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        coach = Coach(_opts(tmp / f"rank{rank}", BATCH // WORLD),
                      dataset=SyntheticFaceDataset(size=S))
        assert coach.distributed and coach.rank == rank
        torch.save(_steps(coach), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _drop_results(tmp_path):
    """The ranks' results and checkpoints are hundreds of MB: delete them."""
    yield
    for f in tmp_path.rglob("*.pt"):
        f.unlink()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process_on_the_union_batch(tmp_path):
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, tmp_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    with torch_threads(2):
        one = _steps(Coach(_opts(tmp_path / "one", BATCH),
                           dataset=SyntheticFaceDataset(size=S)))
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish in time"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    assert [r["shard"] for r in ranks] == [(0, WORLD), (1, WORLD)]
    assert one["shard"] == (0, 1)
    for key in ("net", "D", "net_grads", "d_grads"):
        assert ranks[0][key].keys() == ranks[1][key].keys() == one[key].keys(), key
        for n, t in ranks[0][key].items():
            assert torch.equal(t, ranks[1][key][n]), (key, n)
    for key in ("net_grads", "d_grads"):
        top = max(t.abs().max().item() for t in one[key].values())
        for n, want in one[key].items():
            got = ranks[0][key][n].numpy()
            if want.abs().max() > 1e-3 * top:
                assert rel_err(got, want.numpy()) < 1e-4, (key, n, rel_err(got, want.numpy()))
            else:
                assert np.abs(got - want.numpy()).max() <= 1e-6 * top, (key, n)
    for key in ("net", "D"):
        for n, want in one[key].items():
            # Adam's first update is +-lr, the same sign on both sides but
            # where a gradient is near 0; so within 2 lr of each other
            assert (ranks[0][key][n] - want).abs().max() <= 2e-4 + 1e-6, (key, n)
