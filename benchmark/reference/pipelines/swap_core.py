"""The face swap in plain PyTorch:

  uint8 source/target -> BiSeNet parse of both faces -> 19->12 labels ->
  mask swap -> RGI style vectors (both faces, one batch) -> texture swap ->
  LocalMLPs + latent_avg -> mask-guided synthesis (the 12-conv region loop)
  -> feathered stitch -> uint8 out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models.bisenet import parser_input
from benchmark.reference.ops.morphology import create_masks, erosion
from benchmark.reference.ops.resize import bilinear_resize
from benchmark.reference.utils.label_maps import FFHQ19_PAIRS, lookup_table

# Texture regions taken from the source face; the rest stay the target's:
# all but background 0, hair 4, glasses 10 and earrings 11.
SWAP_COMP_INDICES = tuple(sorted(set(range(12)) - {0, 4, 10, 11}))

# 19 -> detailed 12 classes (face-parsing.PyTorch order) as a lookup table
SEG19_TO_12 = lookup_table(FFHQ19_PAIRS)


def swap_style_vectors_device(target_sv, driven_sv,
                              comp_indices: Sequence[int] = SWAP_COMP_INDICES):
    """Texture swap [B,R,F] with the ear (7) and teeth (9) fallbacks, decided
    over the whole batch."""
    sv = target_sv.clone()
    for i in comp_indices:
        sv[:, i] = driven_sv[:, i]
    ear_absent = driven_sv[:, 7].sum() == 0
    sv[:, 7] = torch.where(ear_absent, (target_sv[:, 7] + driven_sv[:, 7]) / 2,
                           sv[:, 7])
    teeth_absent = driven_sv[:, 9].sum() == 0
    sv[:, 9] = torch.where(teeth_absent, target_sv[:, 9], sv[:, 9])
    return sv


def swap_head_mask_device(source, target, hair_first: bool = True):
    """Head mask swap on integer label maps [..., H, W]: the target keeps
    background, neck, ears, earrings (and hair), the source gives the face
    parts; holes are filled with skin. Returns (swapped, hole_map)."""
    PLACEHOLDER = 99
    res = torch.zeros_like(target)
    res = torch.where(target == 0, PLACEHOLDER, res)
    for cls in (8, 7, 11):
        res = torch.where(target == cls, cls, res)
    if hair_first:
        res = torch.where(target == 4, 4, res)
    for cls in (1, 2, 3, 5, 6, 9):
        res = torch.where((source == cls) & (res != PLACEHOLDER), cls, res)
    if not hair_first:
        res = torch.where(target == 4, 4, res)
    res = torch.where(target == 10, 10, res)
    hole_map = (255 * (res == 0)).to(res.dtype)
    res = torch.where(res == 0, 6, res)
    res = torch.where(res == PLACEHOLDER, 0, res)
    return res, hole_map


def parse12(parser_model, img01, parser_size: int = 512):
    """BiSeNet parse + 19->12 conversion. img01: [B,3,S,S] in [0,1]
    -> [B,ps,ps] int64."""
    seg_out, _, _ = parser_model(parser_input(img01, parser_size))
    lut = torch.as_tensor(SEG19_TO_12, device=img01.device)
    return lut[seg_out.argmax(dim=1)]


def _img_to01(img):
    return img.float() / 255.0 if img.dtype == torch.uint8 else img


def _cv2_gaussian_taps(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma=0): sigma from the ksize formula."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _gaussian_blur(x, ksize: int):
    """Separable Gaussian with zero borders; x: [B,1,H,W]."""
    taps = torch.as_tensor(_cv2_gaussian_taps(ksize), dtype=x.dtype, device=x.device)
    p = ksize // 2
    x = F.conv2d(x, taps.reshape(1, 1, ksize, 1), padding=(p, 0))
    return F.conv2d(x, taps.reshape(1, 1, 1, ksize), padding=(0, p))


def stitch_foreground(swapped_face, target_img, swapped_label, hole_map,
                      outer_dilation: int = 5):
    """Feather the swapped face onto the target: foreground = all classes but
    {0, 11, 4}, holes included, dilated by ``outer_dilation``, resized to the
    image, eroded by (2r+1)^2 and Gaussian-blurred.
    swapped_face/target_img: [B,3,S,S] in [-1,1]; swapped_label, hole_map:
    [B,1,h,w] (hole_map 255 at holes)."""
    mask_bg = (swapped_label == 0) | (swapped_label == 11) | (swapped_label == 4)
    fg = (~mask_bg | (hole_map == 255)).to(swapped_face.dtype)
    _, _, full_mask = create_masks(fg, outer_dilation=outer_dilation)
    S = swapped_face.shape[-1]
    alpha = torch.clamp(bilinear_resize(full_mask, (S, S)), 0.0, 1.0)
    if outer_dilation != 0:
        ksize = 2 * outer_dilation + 1
        alpha = erosion(alpha, np.ones((ksize, ksize), np.float32))
        alpha = torch.clamp(_gaussian_blur(alpha, ksize), 0.0, 1.0)
    return swapped_face * alpha + target_img * (1.0 - alpha)


@torch.no_grad()
def swap_e2e(net, parser_model, src, tgt, latent_avg, parser_size: int = 512):
    """src/tgt: [B,3,S,S] uint8 -> (uint8 image [B,3,S,S], swapped 12-class
    labels [B,ps,ps]). The texture swap's ear and teeth fallbacks are
    decided over the whole batch."""
    B = src.shape[0]
    img01 = torch.cat([_img_to01(src), _img_to01(tgt)])
    seg12 = parse12(parser_model, img01, parser_size)
    d_label, t_label = seg12[:B], seg12[B:]
    swapped_label, hole_map = swap_head_mask_device(d_label, t_label)

    dt = latent_avg.dtype
    cls = torch.arange(net.num_seg_cls, device=src.device)[None, :, None, None]
    d_oh, t_oh, s_oh = ((lab[:, None] == cls).to(dt)
                        for lab in (d_label, t_label, swapped_label))
    imgs = (img01 * 2.0 - 1.0).to(dt)
    sv, _ = net.get_style_vectors(imgs, torch.cat([d_oh, t_oh]))
    swapped_sv = swap_style_vectors_device(sv[B:], sv[:B])
    codes = net.cal_style_codes(swapped_sv, latent_avg)
    struc = torch.zeros((B, 512, 32, 32), dtype=dt, device=src.device)
    face, _, _ = net.gen_img(struc, codes, s_oh, randomize_noise=False)
    stitched = stitch_foreground(face.float(), img01[B:] * 2.0 - 1.0,
                                 swapped_label[:, None], hole_map[:, None])
    # truncating cast, as the reference's tensor2im
    out01 = torch.clamp((stitched + 1.0) / 2.0, 0.0, 1.0)
    return (out01 * 255.0).to(torch.uint8), swapped_label
