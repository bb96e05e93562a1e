"""Texture editing: per-region interpolation of the RGI style vectors of a
source face towards a reference face, regenerated under the source's mask
with fixed noise (counterpart of ``e4s_tpu/pipelines/face_edit.py``).

``interpolation`` edits at one alpha from image files (host parse);
``interpolation_sweep`` parses both faces on the device once and
synthesises every alpha as one batch, so the synthesis makes one launch of
the masked-conv kernel per masked layer for the whole sweep.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from e4s_tpu_torch.datasets.dataset import label_map_to_onehot
from e4s_tpu_torch.models.stylegan2 import generator_channels
from e4s_tpu_torch.pipelines.model_io import (
    load_face_parser,
    load_net3,
    resolve_device,
)
from e4s_tpu_torch.pipelines.swap_core import _img_to01, parse12, parse12_host
from e4s_tpu_torch.utils.img_utils import tensor2im

COMP2INDEX = {
    "background": 0, "lip": 1, "eyebrows": 2, "eyes": 3, "hair": 4,
    "nose": 5, "skin": 6, "ears": 7, "belowface": 8, "mouth": 9,
    "eye_glass": 10, "ear_rings": 11,
}


def sample_fixed_noise(out_size: int, seed: int = 0):
    """The edit's fixed per-layer noise, full-channel ([1,C,r,r], r = 4, 8,
    8, 16, 16, ... out_size), drawn from ``np.random.RandomState(seed)`` in
    the JAX package's order: the same values bit for bit. CPU f32 tensors."""
    rng = np.random.RandomState(seed)
    channels = generator_channels()
    noise = [rng.randn(1, 512, 4, 4).astype(np.float32)]
    res = 8
    while res <= out_size:
        for _ in range(2):
            noise.append(rng.randn(1, channels[res], res, res).astype(np.float32))
        res *= 2
    return [torch.from_numpy(n) for n in noise]


class Editor:
    """Holds Net3, the face parser and the fixed noise on one device.
    ``device`` defaults to the GPU and raises when there is none. ``opts``:
    the fields of ``options/edit_options.py``; ``opts.regions`` names the
    regions (keys of ``COMP2INDEX``) whose texture moves towards the
    reference."""

    def __init__(self, opts, device="cuda", seed: int = 0, parser=None):
        self.opts = opts
        for region in opts.regions:
            if region not in COMP2INDEX:
                raise ValueError(f"unknown region {region!r}; choose from "
                                 + ", ".join(COMP2INDEX))
        self.device = resolve_device(device)
        self.net, self.latent_avg = load_net3(opts, device=self.device, seed=seed)
        self.parser = parser if parser is not None else load_face_parser(
            opts, getattr(opts, "faceParsing_ckpt", None), device=self.device,
            seed=seed)
        self.noise = [n.to(self.device) for n in sample_fixed_noise(opts.out_size)]

    def _alphas(self, alpha_values) -> torch.Tensor:
        """[A, R]: each alpha on the edited regions, 0 elsewhere."""
        a = np.zeros((len(alpha_values), self.opts.num_seg_cls), np.float32)
        for region in self.opts.regions:
            a[:, COMP2INDEX[region]] = np.asarray(alpha_values)
        return torch.from_numpy(a).to(self.device)

    def _mix_and_generate(self, src_sv, ref_sv, src_onehot, alphas):
        """(1 - a) src + a ref per region, then synthesis under the
        source's mask with the fixed noise. alphas: [A, R]."""
        a = alphas[:, :, None].to(src_sv.dtype)
        mixed = (1.0 - a) * src_sv + a * ref_sv
        codes = self.net.cal_style_codes(mixed, self.latent_avg)
        A = alphas.shape[0]
        struc = torch.zeros((A, 512, 32, 32), dtype=src_sv.dtype,
                            device=src_sv.device)
        img, _, _ = self.net.gen_img(
            struc, codes, src_onehot.expand(A, -1, -1, -1),
            randomize_noise=False, noise=self.noise)
        return img

    @torch.no_grad()
    def edit_core(self, src, src_onehot, ref, ref_onehot, alphas):
        """Images [1,3,S,S] in [-1,1] with their one-hot masks; alphas [R]
        -> the edited face [1,3,S,S] in [-1,1]."""
        src_sv, _ = self.net.get_style_vectors(src, src_onehot)
        ref_sv, _ = self.net.get_style_vectors(ref, ref_onehot)
        return self._mix_and_generate(src_sv, ref_sv, src_onehot, alphas[None])

    @torch.no_grad()
    def edit_sweep_core(self, src_u8, ref_u8, alphas):
        """Parse of both faces, style vectors of both, and the A edits as
        one batch: uint8 [1,3,S,S] images and alphas [A, R] -> uint8
        [A,3,S,S]."""
        parser = self.parser
        img01 = torch.cat([_img_to01(src_u8), _img_to01(ref_u8)])
        labels = parse12(parser.model, img01, parser.parser_size, parser.taxonomy)
        dt = self.latent_avg.dtype
        cls = torch.arange(self.net.num_seg_cls, device=img01.device)
        oh = (labels[:, None] == cls[None, :, None, None]).to(dt)
        sv, _ = self.net.get_style_vectors((img01 * 2.0 - 1.0).to(dt), oh)
        img = self._mix_and_generate(sv[:1], sv[1:], oh[:1], alphas)
        out01 = torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0)
        return (out01 * 255.0).to(torch.uint8)

    def _load(self, path) -> np.ndarray:
        """An image file -> uint8 [1,3,S,S]."""
        from PIL import Image

        S = self.opts.out_size
        img = Image.open(path).convert("RGB").resize((S, S))
        return np.ascontiguousarray(np.transpose(np.array(img, np.uint8), (2, 0, 1))[None])

    def interpolation_sweep(self, alpha_values: Sequence[float]):
        """The source edited at each of ``alpha_values`` on ``opts.regions``,
        in one pass on the device. Returns one PIL image per alpha."""
        from PIL import Image

        src, ref = (torch.from_numpy(self._load(p)).to(self.device)
                    for p in (self.opts.source, self.opts.reference))
        out = self.edit_sweep_core(src, ref, self._alphas(alpha_values))
        arr = out.permute(0, 2, 3, 1).cpu().numpy()
        return [Image.fromarray(a) for a in arr]

    def _prep(self, path):
        """Image file -> (image [1,3,S,S] in [-1,1], its one-hot mask from
        the host parse), on the device in the compute dtype."""
        arr01 = self._load(path).astype(np.float32) / 255.0
        label = parse12_host(self.parser, torch.from_numpy(arr01).to(self.device))
        onehot = label_map_to_onehot(label[:, None], self.opts.num_seg_cls)
        dt = self.latent_avg.dtype
        return (torch.from_numpy(arr01 * 2 - 1).to(self.device, dt),
                torch.from_numpy(onehot).to(self.device, dt))

    def interpolation(self):
        """The source edited at ``opts.alpha`` on ``opts.regions``, as a PIL
        image."""
        src, src_onehot = self._prep(self.opts.source)
        ref, ref_onehot = self._prep(self.opts.reference)
        out = self.edit_core(src, src_onehot, ref, ref_onehot,
                             self._alphas([self.opts.alpha])[0])
        return tensor2im(out[0].float().cpu().numpy())
