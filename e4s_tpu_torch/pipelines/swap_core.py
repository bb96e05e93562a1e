"""The face swap as functions of tensors on one device (counterpart of
``e4s_tpu/pipelines/swap_core.py``). The fused path:

  uint8 source/target -> parse of both faces (BiSeNet or SegNeXt) -> 19->12
  labels -> mask swap -> RGI style vectors (both faces, one batch) ->
  texture swap -> LocalMLPs + latent_avg -> mask-guided synthesis ->
  feathered stitch or Laplacian blend -> uint8 out.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from e4s_tpu_torch.models.bisenet import face_parsing_demo, parser_input
from e4s_tpu_torch.models.segnext import segnext_parse19_device
from e4s_tpu_torch.ops.blending import blend_images
from e4s_tpu_torch.ops.morphology import create_masks, erosion
from e4s_tpu_torch.ops.resize import bilinear_resize
from e4s_tpu_torch.utils.label_maps import (
    CELEBA19_PAIRS,
    FFHQ19_PAIRS,
    celebahq_mask_to_faceparser_mask_detailed,
    lookup_table,
)

# Texture regions taken from the source face; the rest stay the target's:
# all but background 0, hair 4, glasses 10 and earrings 11.
SWAP_COMP_INDICES = tuple(sorted(set(range(12)) - {0, 4, 10, 11}))

# 19 -> detailed 12 classes as lookup tables: BiSeNet (face-parsing.PyTorch
# order) and SegNeXt (CelebA order)
SEG19_TO_12 = lookup_table(FFHQ19_PAIRS)
CELEBA19_TO_12 = lookup_table(CELEBA19_PAIRS)
LUTS = {"ffhq19": SEG19_TO_12, "celeba19": CELEBA19_TO_12}


def swap_style_vectors_device(target_sv, driven_sv,
                              comp_indices: Sequence[int] = SWAP_COMP_INDICES):
    """Texture swap [B,R,F] with the ear (7) and teeth (9) fallbacks, decided
    over the whole batch as the JAX package does."""
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


@functools.lru_cache(maxsize=None)
def _lut(taxonomy: str, device: torch.device):
    """``LUTS[taxonomy]`` as a tensor on ``device``, made once."""
    return torch.as_tensor(LUTS[taxonomy], device=device)


def celeba19_to_12_device(seg19):
    """CelebA-order 19-class labels -> the detailed 12 (one gather)."""
    return _lut("celeba19", seg19.device)[seg19]


def parse12(parser_model, img01, parser_size: int = 512,
            taxonomy: str = "ffhq19"):
    """Parse + 19->12 conversion on the device. img01: [B,3,S,S] in [0,1];
    ``taxonomy``: "ffhq19" for BiSeNet, "celeba19" for SegNeXt.
    -> [B,ps,ps] int64."""
    if taxonomy == "celeba19":
        return celeba19_to_12_device(
            segnext_parse19_device(parser_model, img01, parser_size))
    seg_out, _, _ = parser_model(parser_input(img01, parser_size))
    return _lut("ffhq19", img01.device)[seg_out.argmax(dim=1)]


def parse12_host(parser, arr01) -> np.ndarray:
    """Parse + 19->12 conversion for a parser wrapper (``FaceParser`` or
    ``SegNeXtFaceParser``), by its ``taxonomy``. arr01: [B,3,S,S] in [0,1]
    on the parser's device -> numpy uint8 labels [B,ps,ps]."""
    if getattr(parser, "taxonomy", "ffhq19") == "celeba19":
        seg = parser(arr01).cpu().numpy().astype(np.uint8)
        return np.stack([celebahq_mask_to_faceparser_mask_detailed(s) for s in seg])
    return face_parsing_demo(parser, arr01, True)


def _img_to01(img):
    return img.float() / 255.0 if img.dtype == torch.uint8 else img


def _cv2_gaussian_taps(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma=0): sigma from the ksize formula."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gaussian_taps(ksize: int, dtype: torch.dtype, device: torch.device):
    """The taps as a tensor on ``device``, made once per size."""
    return torch.as_tensor(_cv2_gaussian_taps(ksize), dtype=dtype, device=device)


def _gaussian_blur(x, ksize: int):
    """Separable Gaussian with zero borders; x: [B,1,H,W]."""
    taps = _gaussian_taps(ksize, x.dtype, x.device)
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


def make_swap_core(net, from_labels: bool = False):
    """Returns swap_core(driven, target, driven_onehot, target_onehot,
    swapped_onehot, latent_avg) -> swapped face [B,3,S,S] in [-1,1]. With
    ``from_labels`` the three masks are label maps [B,1,H,W] and the
    one-hots are built here."""

    @torch.no_grad()
    def swap_core(driven, target, driven_onehot, target_onehot,
                  swapped_onehot, latent_avg):
        if from_labels:
            cls = torch.arange(net.num_seg_cls, device=driven.device)
            cls = cls[None, :, None, None]
            driven_onehot, target_onehot, swapped_onehot = (
                (m == cls).to(driven.dtype)
                for m in (driven_onehot, target_onehot, swapped_onehot)
            )
        nb = driven.shape[0]
        sv, _ = net.get_style_vectors(
            torch.cat([driven, target]), torch.cat([driven_onehot, target_onehot])
        )
        swapped_sv = swap_style_vectors_device(sv[nb:], sv[:nb])
        codes = net.cal_style_codes(swapped_sv, latent_avg)
        struc = torch.zeros((nb, 512, 32, 32), dtype=driven.dtype,
                            device=driven.device)
        img, _, _ = net.gen_img(struc, codes, swapped_onehot,
                                randomize_noise=False)
        return img

    return swap_core


def lap_blend_stitch(face, target255, swapped_label, hole_map,
                     outer_dilation: int = 5):
    """The ``lap_bld`` stitch: content and border masks from the swapped
    labels (foreground = all but {0, 11, 4}, holes included, expanded by
    ``outer_dilation``), the face pasted under the content mask, then the
    10-level Laplacian blend of that paste over the target under the border
    mask. face: [B,3,S,S] in [-1,1]; target255: [B,3,S,S] in [0,255];
    swapped_label, hole_map: [B,1,h,w]. -> [B,3,S,S] f32 in [0,255]."""
    mask_bg = (swapped_label == 0) | (swapped_label == 11) | (swapped_label == 4)
    fg = (~mask_bg | (hole_map == 255)).float()
    content_mask, border_mask, _ = create_masks(
        fg, outer_dilation=outer_dilation, operation="expansion")
    S = face.shape[-1]
    content_mask = bilinear_resize(content_mask, (S, S))
    border_mask = bilinear_resize(border_mask, (S, S))
    swapped255 = (face.float() + 1.0) / 2.0 * 255.0
    pasted = swapped255 * content_mask + target255 * (1 - content_mask)
    return blend_images(target255, pasted, border_mask.expand(-1, 3, -1, -1))


def make_swap_e2e(net, parser_model, parser_size: int = 512,
                  taxonomy: str = "ffhq19", lap_bld: bool = False):
    """Returns swap_e2e(src, tgt, latent_avg) -> (uint8 image [B,3,S,S],
    swapped 12-class labels, hole map, source labels, target labels).
    src/tgt: [B,3,S,S] uint8 (or float in [0,1]) on the models' device.
    The encoder and the synthesis run in latent_avg's dtype; the parse, the
    stitch and the quantisation in f32.
    ``taxonomy`` names the parser family ("ffhq19": BiSeNet, "celeba19":
    SegNeXt); ``lap_bld`` stitches with the Laplacian blend instead of the
    feathered paste."""
    if taxonomy not in LUTS:
        raise ValueError(f"unknown taxonomy {taxonomy!r}")

    @torch.no_grad()
    def swap_e2e(src, tgt, latent_avg):
        B = src.shape[0]
        img01 = torch.cat([_img_to01(src), _img_to01(tgt)])
        seg12 = parse12(parser_model, img01, parser_size, taxonomy)
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
        if lap_bld:
            blended = lap_blend_stitch(face, img01[B:].float() * 255.0,
                                       swapped_label[:, None], hole_map[:, None])
            out_u8 = torch.clamp(blended, 0.0, 255.0).to(torch.uint8)
        else:
            # in f32 whatever the compute dtype
            stitched = stitch_foreground(face.float(), img01[B:] * 2.0 - 1.0,
                                         swapped_label[:, None], hole_map[:, None])
            # truncating cast, as the reference's tensor2im
            out01 = torch.clamp((stitched + 1.0) / 2.0, 0.0, 1.0)
            out_u8 = (out01 * 255.0).to(torch.uint8)
        return out_u8, swapped_label, hole_map, d_label, t_label

    return swap_e2e


def reconstruct_core(net):
    """Returns recon(img, onehot, latent_avg): encode and regenerate with
    the same mask (the base of editing and inversion). img: [B,3,S,S] in
    [-1,1]; onehot: [B,R,S,S]."""

    @torch.no_grad()
    def recon(img, onehot, latent_avg):
        sv, _ = net.get_style_vectors(img, onehot)
        codes = net.cal_style_codes(sv, latent_avg)
        struc = torch.zeros((img.shape[0], 512, 32, 32), dtype=img.dtype,
                            device=img.device)
        out, _, _ = net.gen_img(struc, codes, onehot, randomize_noise=False)
        return out

    return recon
