"""pSp's legacy encoders (counterpart of ``e4s_tpu/models/psp_legacy.py``;
the reference's ``psp_encoders.py``): a frozen-BatchNorm IR-50 trunk (IR or
IR-SE units) under four heads. The reference's Net3 builds only
FSEncoder_PSP, so no released E4S checkpoint reaches these; they keep
pSp's ``state_dict`` keys (``input_layer``, ``body``, ``styles``,
``latlayer1/2``, ``output_layer_2``, ``linear``).

- ``GradualStyleEncoder``: taps at body units 6, 20 and 23, a top-down
  lateral fusion (bilinear, align_corners) and one ``GradualStyleBlock``
  per style: 3 coarse from the 16^2 map, 4 middle from 32^2, the rest fine
  from 64^2 (at 256^2 input).
- ``BackboneEncoderUsingLastLayerIntoW``: the trunk, a global mean and an
  ``EqualLinear`` -> one w [B,512].
- ``BackboneEncoderUsingLastLayerIntoWPlus``: the trunk, BatchNorm, a 7x7
  adaptive mean and a Linear, then an ``EqualLinear`` -> [B,n_styles,512].
- ``CustomBackboneEncoderUsingLastLayerIntoWPlus``: that with 11 styles and
  a 1x1 ``structure_linear`` head on unit 20's map.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.models.encoders import BottleneckIRSE, FrozenBatchNorm, irse50_blocks
from e4s_tpu_torch.models.layers import EqualConv2d, EqualLinear


class GradualStyleBlock(nn.Module):
    """A spatial x spatial map -> one style: log2(spatial) stride-2 3x3
    convs with leaky ReLU (0.01), then an ``EqualLinear``."""

    def __init__(self, in_c, out_c, spatial):
        super().__init__()
        self.out_c = out_c
        layers = []
        for i in range(int(math.log2(spatial))):
            layers += [nn.Conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1),
                       nn.LeakyReLU()]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)

    def forward(self, x):
        return self.linear(self.convs(x).reshape(-1, self.out_c))


class _IRTrunk(nn.Module):
    """``input_layer`` (conv, BatchNorm, PReLU) and the 24 IR-50 units of
    ``body``; ``mode`` "ir" or "ir_se" (squeeze-excitation)."""

    def __init__(self, mode="ir"):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode must be 'ir' or 'ir_se', not {mode!r}")
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), FrozenBatchNorm(64), nn.PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIRSE(i, d, s, norm="bn", use_se=mode == "ir_se")
            for i, d, s in irse50_blocks()])

    def trunk(self, x, taps=()):
        """-> (the last unit's map, {unit: its map} for ``taps``)."""
        x = self.input_layer(x)
        feats = {}
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in taps:
                feats[i] = x
        return x, feats


class GradualStyleEncoder(_IRTrunk):
    """x [B,3,S,S] -> W+ codes [B,n_styles,512]."""

    def __init__(self, n_styles=18, mode="ir", coarse_ind=3, middle_ind=7):
        super().__init__(mode)
        self.coarse_ind, self.middle_ind = coarse_ind, middle_ind
        self.styles = nn.ModuleList([
            GradualStyleBlock(512, 512, 16 if i < coarse_ind else 32 if i < middle_ind
                              else 64) for i in range(n_styles)])
        self.latlayer1 = nn.Conv2d(256, 512, 1)
        self.latlayer2 = nn.Conv2d(128, 512, 1)

    @staticmethod
    def _upsample_add(top, lateral):
        return F.interpolate(top, size=lateral.shape[-2:], mode="bilinear",
                             align_corners=True) + lateral

    def forward(self, x):
        _, f = self.trunk(x, taps=(6, 20, 23))
        c1, c2, c3 = f[6], f[20], f[23]
        p2 = self._upsample_add(c3, self.latlayer1(c2))
        p1 = self._upsample_add(p2, self.latlayer2(c1))
        maps = [c3] * self.coarse_ind + [p2] * (self.middle_ind - self.coarse_ind)
        maps += [p1] * (len(self.styles) - self.middle_ind)
        return torch.stack([style(m) for style, m in zip(self.styles, maps)], dim=1)


class BackboneEncoderUsingLastLayerIntoW(_IRTrunk):
    """x [B,3,S,S] -> w [B,512]."""

    def __init__(self, mode="ir"):
        super().__init__(mode)
        self.linear = EqualLinear(512, 512)

    def forward(self, x):
        x, _ = self.trunk(x)
        return self.linear(x.mean(dim=(-2, -1)))


class BackboneEncoderUsingLastLayerIntoWPlus(_IRTrunk):
    """x [B,3,S,S] -> W+ codes [B,n_styles,512]."""

    def __init__(self, n_styles=18, mode="ir"):
        super().__init__(mode)
        self.n_styles = n_styles
        self.output_layer_2 = nn.Sequential(
            FrozenBatchNorm(512), nn.AdaptiveAvgPool2d((7, 7)), nn.Flatten(),
            nn.Linear(512 * 7 * 7, 512))
        self.linear = EqualLinear(512, 512 * n_styles)

    def _codes(self, x):
        return self.linear(self.output_layer_2(x)).reshape(-1, self.n_styles, 512)

    def forward(self, x):
        x, _ = self.trunk(x)
        return self._codes(x)


class CustomBackboneEncoderUsingLastLayerIntoWPlus(BackboneEncoderUsingLastLayerIntoWPlus):
    """x [B,3,S,S] -> (W+ codes [B,n_styles,512], structure features
    [B,512,S/8,S/8] from unit 20's map through a 1x1 ``EqualConv2d``)."""

    def __init__(self, n_styles=11, mode="ir"):
        super().__init__(n_styles, mode)
        self.structure_linear = EqualConv2d(256, 512, 1)

    def forward(self, x):
        x, f = self.trunk(x, taps=(20,))
        return self._codes(x), self.structure_linear(f[20])
