"""Net3: RGI encoder + 12 per-region LocalMLPs + mask-guided Generator.

``latent_avg`` is an explicit argument: it is checkpoint data beside the
state_dict, not a parameter (the reference's checkpoint stores it apart).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.models.encoders import FSEncoderPSP
from benchmark.reference.models.layers import EqualLinear
from benchmark.reference.models.stylegan2 import Generator
from benchmark.reference.ops.resize import bilinear_resize

DIM_S_CODE = 256 + 512 + 512


class LocalMLP(nn.Module):
    """Texture code -> W^{r+} for one region (keys ``mlp.0``, ``mlp.2``)."""

    def __init__(self, dim_component=DIM_S_CODE, dim_style=512,
                 num_w_layers=13):
        super().__init__()
        self.dim_style = dim_style
        self.num_w_layers = num_w_layers
        self.mlp = nn.Sequential(
            EqualLinear(dim_component, dim_style),
            nn.LeakyReLU(0.01),
            EqualLinear(dim_style, dim_style * num_w_layers),
        )

    def forward(self, x):
        return self.mlp(x).reshape(-1, self.num_w_layers, self.dim_style)


class Net3(nn.Module):
    def __init__(self, num_seg_cls=12, out_size=1024, remaining_layer_idx=13,
                 split_layer_idx=5, n_styles=18, start_from_latent_avg=True,
                 encoder_size=256, encoder_slim=False, ch_div=1):
        """``encoder_size``, ``encoder_slim`` and ``ch_div`` (the encoder's
        input size, one trunk unit per stage, narrower G stages) are knobs
        for small test models; the defaults are the published model."""
        super().__init__()
        self.num_seg_cls = num_seg_cls
        self.remaining_layer_idx = remaining_layer_idx
        self.n_styles = n_styles
        self.start_from_latent_avg = start_from_latent_avg
        self.encoder_size = encoder_size
        self.encoder = FSEncoderPSP(num_seg_cls, slim=encoder_slim)
        num_w = remaining_layer_idx if remaining_layer_idx != 17 else 18
        self.MLPs = nn.ModuleList(
            [LocalMLP(DIM_S_CODE, 512, num_w) for _ in range(num_seg_cls)]
        )
        self.G = Generator(out_size, 512, 8, split_layer_idx=split_layer_idx,
                           remaining_layer_idx=remaining_layer_idx, ch_div=ch_div)

    def forward(self, img, mask, latent_avg=None, randomize_noise=True,
                noise=None, return_latents=False):
        """img: [B,3,S,S] in [-1,1]; mask: [B,R,S,S] one-hot."""
        codes_vector, structure_feats = self.get_style_vectors(img, mask)
        style_codes = self.cal_style_codes(codes_vector, latent_avg)
        images, latent, feats = self.G(
            [style_codes], structure_feats, mask, input_is_latent=True,
            randomize_noise=randomize_noise, noise=noise,
            return_latents=return_latents,
        )
        if return_latents:
            return images, feats, latent
        return images, feats

    def get_style_vectors(self, img, mask):
        """[B,3,S,S] -> ([B,R,1280], zeros)."""
        img = bilinear_resize(img, (self.encoder_size, self.encoder_size))
        return self.encoder(img, mask)

    def cal_style_codes(self, style_vectors, latent_avg=None):
        """[B,R,1280] -> W^{r+} [B,R,n_styles,512]."""
        B, R = style_vectors.shape[:2]
        K = self.remaining_layer_idx
        codes = torch.stack(
            [self.MLPs[i](style_vectors[:, i]) for i in range(self.num_seg_cls)],
            dim=1,
        )
        if self.start_from_latent_avg:
            if latent_avg is None:
                raise ValueError("start_from_latent_avg needs the latent_avg")
            la = latent_avg.to(codes.dtype)
            if K != 17:
                codes = codes + la[None, None, :K]
                rest = la[None, None, K:].expand(B, R, self.n_styles - K, -1)
                codes = torch.cat([codes, rest], dim=2)
            else:
                codes = codes + la[None, None]
        return codes

    def gen_img(self, struc_codes, style_codes, mask, randomize_noise=True,
                noise=None, return_latents=False):
        images, latent, feats = self.G(
            [style_codes], struc_codes, mask, input_is_latent=True,
            randomize_noise=randomize_noise, noise=noise,
            return_latents=return_latents,
        )
        return images, (latent if return_latents else -1), feats
