"""Latent inversion: refine a face's RGI style vectors [1,R,1280] (and, with
``optimize_noise``, the generator's per-layer noise maps) so that the
regenerated face matches the image (counterpart of
``e4s_tpu/pipelines/optimization.py::Optimizer``).

The loss is ID (IR-SE50 features) + L2 + LPIPS (AlexNet, at three scales)
+ face-parsing features, weighted by the options. Each step is one forward
and one autograd backward, in a plain loop: every masked layer's forward
launches the masked-conv kernel, and its gradient goes through the kernel's
plain version, as the JAX package's goes through XLA. Under ``bf16`` Net3
and the criteria run in bfloat16 while the optimised leaves and the
optimizer's moments stay float32 (the cast to bf16 is inside the step, so
the gradient flows back to the f32 leaves).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from e4s_tpu_torch.criteria.id_loss import IDLoss
from e4s_tpu_torch.criteria.parsing_loss import FaceParsingLoss
from e4s_tpu_torch.datasets.dataset import (
    CelebAHQDataset,
    SyntheticFaceDataset,
    label_map_to_onehot,
)
from e4s_tpu_torch.models.lpips_nets import LPIPS
from e4s_tpu_torch.ops.resize import adaptive_avg_pool2d
from e4s_tpu_torch.pipelines.model_io import load_net3, materialise, resolve_device
from e4s_tpu_torch.utils.img_utils import tensor2im

OPTIMIZERS = ("sgd", "sgdm", "adam", "adamax")


class CountedOptimizer(torch.optim.Optimizer):
    """An optimizer that counts its updates as an optax state does (one
    count, kept in ``state_dict``), with ``lr`` a float or a schedule as
    optax takes one: a function of the count of earlier updates."""

    def __init__(self, params, lr):
        super().__init__(list(params), {})
        self.lr = lr
        self.count = 0

    def state_dict(self):
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    def _next_lr(self):
        """Counts an update; returns its learning rate."""
        self.count += 1
        return self.lr(self.count - 1) if callable(self.lr) else self.lr

    def _params_and_grads(self):
        """The parameters and their ``.grad``, a missing one zero (as a
        frozen JAX leaf's)."""
        params = self.param_groups[0]["params"]
        return params, [torch.zeros_like(p) if p.grad is None else p.grad
                        for p in params]


class OptaxRule(CountedOptimizer):
    """The update rules of the JAX package's four optimizers
    (``make_optimizer``: ``optax.sgd``, ``sgd`` with momentum 0.9,
    ``adam``, ``adamax``, defaults b1 0.9, b2 0.999, eps 1e-8), written as
    optax defines them, on f32 tensors updated in place. Adamax differs
    from ``torch.optim.Adamax``: optax divides by max(|g| + eps, b2 u).
    ``step()`` reads every parameter's ``.grad``."""

    def __init__(self, name: str, lr, params, b1=0.9, b2=0.999, eps=1e-8):
        if name not in OPTIMIZERS:
            name = "adam"  # the JAX package's fallback for other names
        super().__init__(params, lr)
        self.name, self.b1, self.b2, self.eps = name, b1, b2, eps
        for p in self.param_groups[0]["params"]:
            self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _bias_correction(self, decay) -> float:
        """1 - decay**count in f32, as optax computes it."""
        return float(np.float32(1) - np.power(np.float32(decay),
                                              np.float32(self.count),
                                              dtype=np.float32))

    @torch.no_grad()
    def step(self):
        lr = self._next_lr()
        params, grads = self._params_and_grads()
        b1, b2 = self.b1, self.b2
        for p, g in zip(params, grads):
            mu, nu = self.state[p]["mu"], self.state[p]["nu"]
            if self.name == "sgd":
                u = g
            elif self.name == "sgdm":
                mu.copy_(g + b1 * mu)  # optax.trace(decay=0.9)
                u = mu
            else:
                mu.copy_((1 - b1) * g + b1 * mu)
                mu_hat = mu / self._bias_correction(b1)
                if self.name == "adam":
                    nu.copy_((1 - b2) * g ** 2 + b2 * nu)
                    nu_hat = nu / self._bias_correction(b2)
                    u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
                else:  # adamax
                    nu.copy_(torch.maximum(g.abs() + self.eps, b2 * nu))
                    u = mu_hat / nu
            p.add_(u * -lr)


def _load_aux(build, path: Optional[str], prefix: str, seed: int, device):
    """A frozen criterion network: the checkpoint at ``path`` (its keys under
    ``prefix``) when the file exists, else seeded random weights."""
    sd = None
    if path and os.path.exists(path):
        raw = torch.load(path, map_location="cpu", weights_only=False)
        raw = raw.get("state_dict", raw)
        sd = {prefix + k.removeprefix("module."): v for k, v in raw.items()}
    elif path:
        print(f"[e4s_tpu_torch] checkpoint {path} not found; random weights "
              f"from seed {seed}")
    return materialise(build, sd, seed, device)


class Optimizer:
    """Holds Net3, the criteria and the dataset on one device; call
    ``invertion(sample_idx)``. ``device`` defaults to the GPU and raises when
    there is none. ``opts``: the fields of ``options/optim_options.py``.
    ``dataset``: anything indexable to (image [3,S,S] in [-1,1], label
    [1,S,S], _), else CelebAMask-HQ's test split under ``dataset_root``,
    else the synthetic faces."""

    def __init__(self, opts, dataset=None, device="cuda", seed: int = 0):
        self.opts = opts
        self.device = resolve_device(device)
        if dataset is not None:
            self.test_ds = dataset
        elif os.path.isdir(os.path.join(opts.dataset_root, "CelebA-HQ-img")):
            self.test_ds = CelebAHQDataset(opts.dataset_root, mode="test",
                                           fraction=opts.ds_frac)
        else:
            print(f"[e4s_tpu_torch] CelebAMask-HQ not found at "
                  f"{opts.dataset_root}; using the synthetic dataset")
            self.test_ds = SyntheticFaceDataset(
                size=opts.out_size, num_seg_cls=opts.num_seg_cls, length=256)
        self.net, self.latent_avg = load_net3(opts, device=self.device, seed=seed)
        self.dtype = self.latent_avg.dtype
        dev = self.device
        self.id_loss = self.lpips = self.parsing_loss = None
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
        for m in (self.id_loss, self.lpips, self.parsing_loss):
            if m is not None:
                m.to(self.dtype)

    def calc_loss(self, img, recon):
        """(weighted total, the terms by name) of ``recon`` against ``img``,
        both [B,3,S,S] in [-1,1] in the compute dtype."""
        opts = self.opts
        loss = 0.0
        aux = {}
        if self.id_loss is not None:
            aux["loss_id"], _ = self.id_loss(recon, img)
            loss = loss + aux["loss_id"] * opts.id_lambda
        if opts.l2_lambda > 0:
            # f32 accumulation (a bf16 mean over 1024^2 drifts)
            aux["loss_l2"] = torch.mean(((recon - img).float()) ** 2)
            loss = loss + aux["loss_l2"] * opts.l2_lambda
        if self.lpips is not None:
            lp = 0.0
            for i in range(3):
                s = max(opts.out_size // 2 ** i, 32)
                lp = lp + self.lpips(adaptive_avg_pool2d(recon, (s, s)),
                                     adaptive_avg_pool2d(img, (s, s)))
            aux["loss_lpips"] = lp
            loss = loss + lp * opts.lpips_lambda
        if self.parsing_loss is not None:
            aux["loss_face_parsing"], _ = self.parsing_loss(recon, img)
            loss = loss + aux["loss_face_parsing"] * opts.face_parsing_lambda
        aux["loss"] = loss
        return loss, aux

    def gen_from_sv(self, style_vectors, onehot, noise=None):
        """Style vectors [B,R,1280] -> the face [B,3,S,S] under ``onehot``,
        with the given per-layer noise or the generator's own buffers."""
        codes = self.net.cal_style_codes(style_vectors, self.latent_avg)
        struc = torch.zeros((style_vectors.shape[0], 512, 32, 32),
                            dtype=style_vectors.dtype, device=style_vectors.device)
        img, _, _ = self.net.gen_img(struc, codes, onehot, randomize_noise=False,
                                     noise=noise)
        return img

    def _noise_init(self):
        """The generator's registered noise maps, as f32 leaves to refine."""
        G = self.net.G
        return [getattr(G.noises, f"noise_{i}").detach().float().clone()
                for i in range(G.num_layers)]

    def invertion(self, sample_idx: int, save: bool = True):
        """Refine the style vectors of dataset item ``sample_idx`` for
        ``W_steps`` steps. Returns (style vectors, final face f32, the loss
        of every step as numpy). With ``save``: under
        ``output_dir/sample_<i>`` the image, the encoder's reconstruction,
        the final face and style vectors (``_<W_steps>.png/.npy``), with
        ``save_intermediate`` every ``save_interval`` steps' style vectors
        and faces, and with ``optimize_noise`` the noise maps (``.npz``)."""
        opts = self.opts
        dt = self.dtype
        img_np, label_np, _ = self.test_ds[sample_idx]
        img = torch.from_numpy(np.ascontiguousarray(img_np[None], np.float32)).to(self.device)
        onehot = torch.from_numpy(label_map_to_onehot(
            np.asarray(label_np)[None], opts.num_seg_cls)).to(self.device)
        img_c, onehot_c = img.to(dt), onehot.to(dt)
        with torch.no_grad():
            sv_init, _ = self.net.get_style_vectors(img_c, onehot_c)
            recon0 = self.gen_from_sv(sv_init, onehot_c)

        theta = [sv_init.float().clone().requires_grad_(True)]
        if getattr(opts, "optimize_noise", False):
            theta += [n.requires_grad_(True) for n in self._noise_init()]
        rule = OptaxRule(opts.opt_name, opts.lr, theta)
        keep_trace = save and getattr(opts, "save_intermediate", False)
        losses, trace = [], []
        for _ in range(opts.W_steps):
            t = [p.to(dt) for p in theta]
            recon = self.gen_from_sv(t[0], onehot_c, noise=t[1:] or None)
            loss, _ = self.calc_loss(img_c, recon)
            loss = loss.float()
            rule.zero_grad()
            loss.backward(inputs=theta)
            rule.step()
            losses.append(loss.detach())
            if keep_trace:
                trace.append(theta[0].detach().clone())
        sv = theta[0].detach()
        noise = [n.detach() for n in theta[1:]]
        with torch.no_grad():
            recon = self.gen_from_sv(sv.to(dt), onehot_c,
                                     noise=[n.to(dt) for n in noise] or None).float()
        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)

        if save:
            self._save(sample_idx, img, recon0, recon, sv, trace, noise, onehot_c)
        return sv, recon, losses

    def _save(self, sample_idx, img, recon0, recon, sv, trace, noise, onehot_c):
        opts = self.opts
        name = f"sample_{sample_idx}"
        folder = os.path.join(opts.output_dir, name)
        os.makedirs(folder, exist_ok=True)

        def png(t, suffix):
            tensor2im(t[0].float().cpu().numpy()).save(
                os.path.join(folder, f"{name}_{suffix}.png"))

        png(img, "gt")
        png(recon0, "recon")
        steps = range(opts.save_interval, opts.W_steps, opts.save_interval)
        for step in steps if trace else ():
            inter = trace[step - 1]
            np.save(os.path.join(folder, f"{name}_{step:04d}.npy"), inter.cpu().numpy())
            with torch.no_grad():
                png(self.gen_from_sv(inter.to(self.dtype), onehot_c), f"{step:04d}")
        png(recon, f"{opts.W_steps:04d}")
        np.save(os.path.join(folder, f"{name}_{opts.W_steps:04d}.npy"), sv.cpu().numpy())
        if noise:
            np.savez(os.path.join(folder, f"{name}_{opts.W_steps:04d}_noise.npz"),
                     *[n.cpu().numpy() for n in noise])
