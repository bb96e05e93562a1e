"""The E4S training loop (counterpart of ``e4s_tpu/training/coach.py``).

Each step is plain eager PyTorch: a G step (Net3 forward, the criteria, the
adversarial G loss, one backward, the optimizer, the EMA), every
``d_every`` steps a D step (G forward without a gradient, D on the fake
and the real batch, the adversarial D loss) and every ``d_reg_every``
steps a lazy R1 step (a double backward through D). Every masked layer of
a G forward launches the masked-conv kernel; its gradient goes through the
kernel's plain version (``ops/kernel_lib.py::PlainGrad``), as the
JAX package's goes through XLA.

What the JAX package does with a mesh and gradient masks, the port does
with ``requires_grad`` and ``DistributedDataParallel``:

- the frozen parts (G's style MLP, G's layers from style index K on, all
  of G without ``train_G``) have ``requires_grad`` off and are not given to
  the optimizer; a frozen JAX leaf gets a zero gradient and so never moves
  under Adam or Ranger either (``trainable``);
- under ``torch.distributed`` (one process per card) Net3 and D are
  wrapped in DDP, the loader takes the process's shard, and only rank 0
  logs and saves. D is wrapped with both of its calls of a D step in one
  forward (``_Pair``), and the R1 penalty adds 0 x D(x) so that its
  backward reaches every parameter and DDP's reducer.

``bf16`` follows the JAX ``_mp``: f32 master weights, optimizer and EMA;
the G and D steps cast the parameters to bf16 inside the step through
``torch.func.functional_call`` (``_Cast``), so the gradient flows back
through the cast to the f32 weights; the frozen criteria are cast once;
R1 runs in f32. Noise is drawn from a ``torch.Generator`` on the device.

A checkpoint is one ``torch.save`` file with the reference's keys
(``state_dict``, ``state_dict_ema``, ``latent_avg``, ``D_state_dict``),
which ``pipelines/model_io.py::load_net3`` reads, plus both optimizers'
states, the step and the best validation loss, so that a resumed run
continues with the same moments.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call

from e4s_tpu_torch.criteria.adv_loss import adv_d_loss, adv_g_loss, d_r1_loss
from e4s_tpu_torch.criteria.id_loss import IDLoss
from e4s_tpu_torch.criteria.parsing_loss import FaceParsingLoss
from e4s_tpu_torch.criteria.style_loss import StyleLoss
from e4s_tpu_torch.criteria.w_norm import w_norm_loss
from e4s_tpu_torch.datasets.dataset import (
    CelebAHQDataset,
    DataLoader,
    FFHQDataset,
    SyntheticFaceDataset,
)
from e4s_tpu_torch.models.lpips_nets import LPIPS
from e4s_tpu_torch.models.stylegan2 import Discriminator
from e4s_tpu_torch.ops.resize import adaptive_avg_pool2d
from e4s_tpu_torch.pipelines.model_io import build_net, materialise, resolve_device
from e4s_tpu_torch.pipelines.optimization import OptaxRule, _load_aux
from e4s_tpu_torch.training.ranger import Ranger, step_decay
from e4s_tpu_torch.utils.img_utils import (
    aggregate_loss_dict,
    tensor2im,
    tensor2map,
    vis_faces,
)

ACCUM = 0.5 ** (32 / (100 * 1000))  # EMA decay per G step


def trainable(name: str, *, train_G: bool, remaining_layer_idx: int) -> bool:
    """Whether Net3's parameter ``name`` trains: G's style MLP never; none
    of G without ``train_G``; with K = ``remaining_layer_idx`` other than 17,
    not ``G.convs.j`` with j + 1 >= K nor ``G.to_rgbs.j`` with 2j + 3 >= K."""
    parts = name.split(".")
    if parts[0] != "G":
        return True
    if not train_G or parts[1] == "style":
        return False
    K = remaining_layer_idx
    if K != 17 and parts[1] == "convs" and int(parts[2]) + 1 >= K:
        return False
    if K != 17 and parts[1] == "to_rgbs" and 2 * int(parts[2]) + 3 >= K:
        return False
    return True


class _Cast(nn.Module):
    """Runs ``module`` with its floating parameters cast to ``dtype``
    (``torch.func.functional_call``; the gradient flows back through the
    cast), or as it is in float32. DDP wraps this, so a cast step is one
    DDP forward."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, dtype, *args, **kwargs):
        if dtype == torch.float32:
            return self.module(*args, **kwargs)
        params = {n: p.to(dtype) for n, p in self.module.named_parameters()}
        return functional_call(self.module, params, args, kwargs)


class _Pair(nn.Module):
    """D on each of its inputs: the fake and the real batch of a D step in
    one forward (DDP takes one forward per backward)."""

    def __init__(self, D):
        super().__init__()
        self.D = D

    def forward(self, *imgs):
        return tuple(self.D(x) for x in imgs)


def init_distributed(device: str, init_method: Optional[str] = None):
    """Joins the process group of torchrun's environment (or
    ``init_method``): NCCL on the card, gloo on the CPU. Returns the
    process's device (``cuda:LOCAL_RANK`` on the card)."""
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        resolve_device(device)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method)
    return device


class Coach:
    """Builds Net3, D, the criteria and the optimizers on ``device`` (the
    card unless asked otherwise); ``train()`` runs the loop. ``opts``: the
    fields of ``options/train_options.py`` (and ``encoder_size``,
    ``encoder_slim``, ``ch_div``, the knobs of small test models that
    ``build_net`` reads). ``dataset``: used for training and validation in
    place of the named one. Under an initialised ``torch.distributed``
    group the models are wrapped in DDP."""

    def __init__(self, opts, dataset=None, device=None, seed: int = 0):
        self.opts = opts
        self.device = resolve_device(device or opts.device)
        self.dataset_override = dataset
        self.global_step = 0
        self.best_val_loss = None
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world = dist.get_world_size() if self.distributed else 1
        self.bf16 = bool(getattr(opts, "bf16", False))
        self.dtype = torch.bfloat16 if self.bf16 else torch.float32
        dev = self.device

        self.net = materialise(lambda: build_net(opts), None, seed, dev)
        self.D = None
        if opts.train_D:
            self.D = materialise(
                lambda: Discriminator(opts.out_size, ch_div=getattr(opts, "ch_div", 1)),
                None, seed + 1, dev)
        self.latent_avg = torch.zeros((opts.n_styles, 512), device=dev)
        resuming = bool(getattr(opts, "checkpoint_path", None))
        bootstrapped = not resuming and self._load_stylegan(
            getattr(opts, "stylegan_weights", None))
        if not bootstrapped and opts.start_from_latent_avg and not resuming:
            g = torch.Generator().manual_seed(0)  # the same z on every device
            with torch.no_grad():
                la = self.net.G.mean_latent(int(opts.latent_avg_samples), g)
            self.latent_avg = la.expand(opts.n_styles, -1).clone()

        train_G = opts.train_G and opts.train_D  # as the JAX package's mask
        K = opts.remaining_layer_idx
        params = []
        for name, p in self.net.named_parameters():
            p.requires_grad_(trainable(name, train_G=train_G, remaining_layer_idx=K))
            if p.requires_grad:
                params.append(p)
        self.ema = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        d_ratio = (opts.d_reg_every / (opts.d_reg_every + 1)
                   if opts.d_reg_every > 0 else 1.0)
        self.opt = self._optimizer(params, opts.learning_rate)
        self.opt_d = None
        if self.D is not None:
            self.D.requires_grad_(True)
            self.opt_d = self._optimizer(list(self.D.parameters()),
                                         opts.learning_rate * d_ratio)

        self.id_loss = self.lpips = self.parsing_loss = self.style_loss = None
        if opts.id_lambda > 0:
            self.id_loss = _load_aux(
                lambda: IDLoss(multiscale=opts.id_loss_multiscale),
                getattr(opts, "ir_se50_path", None), "facenet.", seed, dev)
        if opts.lpips_lambda > 0:
            self.lpips = _load_aux(lambda: LPIPS("alex"), None, "", seed, dev)
        if opts.face_parsing_lambda > 0:
            self.parsing_loss = _load_aux(
                FaceParsingLoss, getattr(opts, "face_parsing_model_path", None),
                "G.", seed, dev)
        if opts.style_lambda > 0:
            self.style_loss = _load_aux(
                lambda: StyleLoss(normalize=opts.style_loss_norm == 1), None, "",
                seed, dev)
        for m in (self.id_loss, self.lpips, self.parsing_loss, self.style_loss):
            if m is not None:
                m.to(self.dtype)

        self.g_cast = _Cast(self.net)
        self.g_fwd = self._ddp(self.g_cast)
        self.d_fwd = self._ddp(_Cast(_Pair(self.D))) if self.D is not None else None
        self.noise_gen = torch.Generator(device=dev).manual_seed(
            opts.seed + 17 + self.rank)

        self.checkpoint_dir = os.path.join(opts.exp_dir, "checkpoints")
        self.log_path = os.path.join(opts.exp_dir, "logs", "metrics.jsonl")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        self.tb_writer = None
        if getattr(opts, "tensorboard", False) and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[coach] no TensorBoard ({e}); metrics go to {self.log_path}")
            else:
                self.tb_writer = SummaryWriter(log_dir=os.path.dirname(self.log_path))

    def _optimizer(self, params, lr):
        if self.opts.optim_name == "adam":
            return OptaxRule("adam", step_decay(lr), params)
        return Ranger(params, step_decay(lr))

    def _ddp(self, module):
        if not self.distributed:
            return module
        ids = [self.device.index] if self.device.type == "cuda" else None
        return nn.parallel.DistributedDataParallel(
            module, device_ids=ids, broadcast_buffers=False)

    def _load_stylegan(self, path) -> bool:
        """The StyleGAN2 bootstrap: ``g_ema`` -> G, ``d`` -> D (at 1024^2),
        ``latent_avg`` tiled over the styles, when the file exists."""
        if not path or not os.path.exists(path):
            return False
        ckpt = torch.load(path, map_location=self.device, weights_only=False)
        self.net.G.load_state_dict(ckpt["g_ema"])
        if self.D is not None and "d" in ckpt and self.opts.out_size == 1024:
            self.D.load_state_dict(ckpt["d"])
        print(f"[coach] loaded StyleGAN2 bootstrap from {path}")
        if ckpt.get("latent_avg") is None:
            return False
        la = torch.as_tensor(ckpt["latent_avg"]).float().reshape(1, 512)
        self.latent_avg = la.expand(self.opts.n_styles, -1).clone().to(self.device)
        return True

    # ------------------------------------------------------------ losses

    def _calc_loss(self, img, recon, mask, latent, latent_avg):
        """(weighted sum, the terms by the JAX package's names)."""
        opts = self.opts
        loss = 0.0
        loss_dict = {}
        if self.parsing_loss is not None:
            lp, imp = self.parsing_loss(recon, img)
            loss_dict["loss_face_parsing"], loss_dict["face_parsing_improve"] = lp, imp
            loss = loss + lp * opts.face_parsing_lambda
        if self.id_loss is not None:
            lid, sim = self.id_loss(recon, img)
            loss_dict["loss_id"], loss_dict["id_improve"] = lid, sim
            loss = loss + lid * opts.id_lambda
        if opts.l2_lambda > 0:
            # the 1024^2 reduction in f32 (a bf16 mean drifts)
            l2 = torch.mean(((recon - img).float()) ** 2)
            loss_dict["loss_l2"] = l2
            loss = loss + l2 * opts.l2_lambda
        if self.lpips is not None:
            llp = 0.0
            for i in range(3):
                # at least 32^2: AlexNet's pooling needs it (small models)
                s = max(opts.out_size // 2 ** i, 32)
                r, x = recon, img
                if s != r.shape[-1]:
                    r, x = adaptive_avg_pool2d(r, (s, s)), adaptive_avg_pool2d(x, (s, s))
                llp = llp + self.lpips(r, x)
            loss_dict["loss_lpips"] = llp
            loss = loss + llp * opts.lpips_lambda
        if opts.w_norm_lambda > 0:
            lw = w_norm_loss(latent, latent_avg, opts.start_from_latent_avg)
            loss_dict["loss_w_norm"] = lw
            loss = loss + lw * opts.w_norm_lambda
        if self.style_loss is not None:
            # label 3, as the reference's and the JAX package's Coach take it
            hair = (mask == 3).to(img.dtype)
            ls = self.style_loss(recon, img, mask_x=hair, mask_x_hat=hair)
            loss_dict["loss_style"] = ls
            loss = loss + ls * opts.style_lambda
        loss_dict["loss"] = loss
        return loss, loss_dict

    # ------------------------------------------------------------- steps

    def draw_noise(self, batch: int):
        """One standard normal map [B,1,r,r] per G layer, from the Coach's
        generator, in the compute dtype."""
        return [torch.randn((batch, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)),
                            generator=self.noise_gen, device=self.device
                            ).to(self.dtype)
                for i in range(self.net.G.num_layers)]

    def _net_forward(self, fwd, img, onehot, noise):
        """(face, latent) of Net3 through ``fwd`` in the compute dtype."""
        recon, _, latent = fwd(self.dtype, img, onehot,
                               latent_avg=self.latent_avg.to(self.dtype),
                               noise=noise, randomize_noise=False,
                               return_latents=True)
        return recon, latent

    def _fake_logits(self, recon):
        """D(recon) in the compute dtype, with no gradient into D (its
        parameters detached, outside DDP): the G loss's logits."""
        params = {n: p.detach().to(self.dtype) for n, p in self.D.named_parameters()}
        return functional_call(self.D, params, (recon,))

    def _g_step(self, img, mask, onehot, noise=None):
        """One G update; returns the loss dict (detached tensors). ``noise``:
        the per-layer maps, else drawn."""
        opts, dt = self.opts, self.dtype
        noise = self.draw_noise(img.shape[0]) if noise is None else noise
        img_c, onehot_c = img.to(dt), onehot.to(dt)
        self.opt.zero_grad(set_to_none=True)
        recon, latent = self._net_forward(self.g_fwd, img_c, onehot_c, noise)
        loss, loss_dict = self._calc_loss(img_c, recon, mask, latent,
                                          self.latent_avg.to(dt))
        g_loss = 0.0
        if self.D is not None:
            g_loss = adv_g_loss(self._fake_logits(recon))
        loss_dict["g_loss"] = g_loss
        overall = (loss + opts.g_adv_lambda * g_loss).float()
        loss_dict["loss"] = overall
        overall.backward()
        self.opt.step()
        with torch.no_grad():
            names = list(self.ema)
            ema = [self.ema[n] for n in names]
            torch._foreach_mul_(ema, ACCUM)
            params = dict(self.net.named_parameters())
            torch._foreach_add_(ema, [params[n] for n in names], alpha=1 - ACCUM)
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in loss_dict.items()}

    def _d_step(self, img, onehot, noise=None):
        """One D update on G's faces (no gradient into G) against ``img``."""
        dt = self.dtype
        noise = self.draw_noise(img.shape[0]) if noise is None else noise
        img_c = img.to(dt)
        with torch.no_grad():
            recon, _ = self._net_forward(self.g_cast, img_c, onehot.to(dt), noise)
        self.opt_d.zero_grad(set_to_none=True)
        fake_pred, real_pred = self.d_fwd(dt, recon, img_c)
        d_loss = adv_d_loss(real_pred, fake_pred).float()
        d_loss.backward()
        self.opt_d.step()
        return {"d_loss": d_loss.detach(), "real_score": real_pred.detach().mean(),
                "fake_score_1": fake_pred.detach().mean()}

    def _d_r1_step(self, img):
        """Lazy R1 in f32: r1_lambda / 2 * E|grad_x D(x)|^2 * d_reg_every."""
        opts = self.opts
        img = img.detach().float().requires_grad_(True)
        self.opt_d.zero_grad(set_to_none=True)
        (real_pred,) = self.d_fwd(torch.float32, img)
        r1 = d_r1_loss(real_pred, img)
        # 0 x D(x): every parameter gets a gradient, so DDP's reducer sees all
        (opts.r1_lambda / 2 * r1 * opts.d_reg_every + 0 * real_pred.sum()).backward()
        self.opt_d.step()
        return {"r1_loss": r1.detach()}

    # ---------------------------------------------------------- the loop

    def configure_datasets(self):
        opts = self.opts
        if self.dataset_override is not None:
            train_ds = test_ds = self.dataset_override
        elif opts.dataset_name == "ffhq":
            train_ds = FFHQDataset(opts.ffhq_dataset_root, fraction=opts.ds_frac,
                                   flip_p=opts.flip_p)
            test_ds = CelebAHQDataset(opts.celeba_dataset_root, mode="test",
                                      fraction=opts.ds_frac)
        elif opts.dataset_name == "synthetic":
            train_ds = test_ds = SyntheticFaceDataset(
                size=opts.out_size, num_seg_cls=opts.num_seg_cls)
        else:
            train_ds = CelebAHQDataset(opts.celeba_dataset_root, mode="train",
                                       fraction=opts.ds_frac, flip_p=opts.flip_p)
            test_ds = CelebAHQDataset(opts.celeba_dataset_root, mode="test",
                                      fraction=opts.ds_frac)
        shard = dict(num_seg_cls=opts.num_seg_cls, num_shards=self.world,
                     shard_index=self.rank)
        return (DataLoader(train_ds, opts.batch_size, shuffle=True,
                           drop_last=True, seed=opts.seed, **shard),
                DataLoader(test_ds, opts.batch_size, shuffle=False,
                           drop_last=True, **shard))

    def _to_device(self, batch):
        img, label, onehot = batch
        return (torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(label, np.int32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(onehot, np.float32)).to(self.device))

    def train(self, max_steps: Optional[int] = None):
        """Steps ``global_step`` .. ``max_steps`` (default ``opts.max_steps``)."""
        opts = self.opts
        max_steps = opts.max_steps if max_steps is None else max_steps
        train_loader, test_loader = self.configure_datasets()
        while self.global_step <= max_steps:
            for batch in train_loader:
                if self.global_step > max_steps:
                    break
                img, label, onehot = self._to_device(batch)
                t0 = time.perf_counter()
                d_loss_dict = {}
                if self.D is not None and self.global_step % opts.d_every == 0:
                    d_loss_dict = self._d_step(img, onehot)
                    if opts.d_reg_every != -1 and self.global_step % opts.d_reg_every == 0:
                        d_loss_dict.update(self._d_r1_step(img))
                losses = self._g_step(img, label, onehot)

                if self.global_step % opts.board_interval == 0:
                    loss_dict = {k: float(v) for k, v in losses.items()}
                    # float() above waited for the step
                    loss_dict["step_time_s"] = time.perf_counter() - t0
                    loss_dict.update({k: float(v) for k, v in d_loss_dict.items()})
                    self._log_metrics(loss_dict, prefix="train")
                if opts.image_interval and (
                        self.global_step % opts.image_interval == 0
                        or (self.global_step < 1000 and self.global_step % 25 == 0)):
                    try:
                        with torch.no_grad():
                            recon, _ = self._net_forward(
                                self.g_cast, img.to(self.dtype),
                                onehot.to(self.dtype), self.draw_noise(img.shape[0]))
                        self.log_images("images/train/faces", onehot, img, recon)
                    except Exception as e:  # matplotlib absent, a full disk
                        print(f"[coach] image logging failed: {e!r}")
                if (self.global_step % opts.val_interval == 0 and self.global_step > 0) \
                        or self.global_step == max_steps:
                    val = self.validate(test_loader)
                    if val and (self.best_val_loss is None
                                or val["loss"] < self.best_val_loss):
                        self.best_val_loss = val["loss"]
                        self.checkpoint_me(val, is_best=True)
                if (self.global_step % opts.save_interval == 0 and self.global_step > 0) \
                        or self.global_step == max_steps:
                    self.checkpoint_me({}, is_best=False)
                self.global_step += 1

    @torch.no_grad()
    def validate(self, test_loader, max_batches: int = 16):
        """The G step's losses (and ``g_loss``) of up to ``max_batches`` test
        batches of this process's shard, averaged, in the compute dtype."""
        agg = []
        dt = self.dtype
        for i, batch in enumerate(test_loader):
            if i >= max_batches:
                break
            img, label, onehot = self._to_device(batch)
            img_c = img.to(dt)
            recon, latent = self._net_forward(self.g_cast, img_c, onehot.to(dt),
                                              self.draw_noise(img.shape[0]))
            loss, loss_dict = self._calc_loss(img_c, recon, label, latent,
                                              self.latent_avg.to(dt))
            if self.D is not None:
                g_loss = adv_g_loss(self._fake_logits(recon))
                loss_dict["g_loss"] = g_loss
                loss_dict["loss"] = loss + self.opts.g_adv_lambda * g_loss
            agg.append({k: float(v) for k, v in loss_dict.items()})
        if not agg:
            return None
        loss_dict = aggregate_loss_dict(agg)
        self._log_metrics(loss_dict, prefix="test")
        return loss_dict

    # -------------------------------------------- logging and checkpoints

    def _log_metrics(self, metrics: Dict[str, float], prefix: str):
        if self.rank != 0:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"step": self.global_step, "prefix": prefix,
                                **metrics}) + "\n")
        if self.tb_writer is not None:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(f"{prefix}/{k}", v, self.global_step)
        print(f"[{prefix} step {self.global_step}] "
              + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    def log_images(self, name: str, onehot, img, recon, display_count: int = 2):
        """A matplotlib grid of (face, mask, reconstruction) rows under
        ``exp_dir/logs/<name>/<step>.jpg`` (rank 0)."""
        if self.rank != 0:
            return
        img, onehot, recon = (t.float().cpu().numpy() for t in (img, onehot, recon))
        rows = [{"input_face": tensor2im(img[i]), "input_mask": tensor2map(onehot[i]),
                 "recon_styleCode": tensor2im(recon[i])}
                for i in range(min(display_count, len(img)))]
        fig = vis_faces(rows)
        path = os.path.join(self.opts.exp_dir, "logs", name, f"{self.global_step:06d}.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fig.savefig(path)
        import matplotlib.pyplot as plt

        plt.close(fig)

    def checkpoint_me(self, loss_dict, is_best: bool):
        """Saves ``best_model.pt`` or ``iteration_<step>.pt`` (rank 0)."""
        if self.rank != 0:
            return
        name = "best_model.pt" if is_best else f"iteration_{self.global_step}.pt"
        payload = {
            "state_dict": self.net.state_dict(),
            "state_dict_ema": {**self.net.state_dict(), **self.ema},
            "latent_avg": self.latent_avg,
            "optimizer": self.opt.state_dict(),
            "step": self.global_step,
            "best_val_loss": self.best_val_loss,
        }
        if self.D is not None:
            payload["D_state_dict"] = self.D.state_dict()
            payload["optimizer_d"] = self.opt_d.state_dict()
        torch.save(payload, os.path.join(self.checkpoint_dir, name))
        with open(os.path.join(self.checkpoint_dir, "timestamp.txt"), "a") as f:
            f.write(f"{'**Best**: ' if is_best else ''}Step - {self.global_step}\n"
                    f"{loss_dict}\n")

    def load_checkpoint(self, path: str):
        """Resumes from a ``checkpoint_me`` file: weights, EMA, latent_avg,
        D, the optimizers' moments (when saved), the best validation loss;
        training continues at the step after the saved one."""
        payload = torch.load(path, map_location=self.device, weights_only=False)
        self.net.load_state_dict(payload["state_dict"])
        ema = payload.get("state_dict_ema", payload["state_dict"])
        with torch.no_grad():
            for n, e in self.ema.items():
                e.copy_(ema[n])
        self.latent_avg = torch.as_tensor(payload["latent_avg"]).float().to(self.device)
        if payload.get("optimizer") is not None:
            self.opt.load_state_dict(payload["optimizer"])
        if self.D is not None and "D_state_dict" in payload:
            self.D.load_state_dict(payload["D_state_dict"])
            if payload.get("optimizer_d") is not None:
                self.opt_d.load_state_dict(payload["optimizer_d"])
        if payload.get("best_val_loss") is not None:
            self.best_val_loss = float(payload["best_val_loss"])
        self.global_step = int(payload.get("step", 0)) + 1
