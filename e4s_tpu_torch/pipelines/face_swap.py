"""Face-swap entry point of the port (counterpart of
``e4s_tpu/pipelines/face_swap.py::FaceSwapper``):

  (1) optional crop and alignment of source and/or target (host);
  (1b) with a re-enactor and a restorer, the source is driven by the
      target's pose (FaceVid2Vid) and restored (GPEN), on the device
      (``reenact_restore.py``), before every swap path; without them the
      source is swapped as it is (D = S);
  (2) the swap: with no target mask, one fused pass on the device (parse,
      mask swap, style extraction, texture swap, synthesis, feathered
      stitch or Laplacian blend); with a caller's target mask, the staged
      path (host parse and mask swap, the swap core on the device, then the
      stitch);
  (3) after a crop, the inverse-perspective paste into the original frame.

With ``opts.bf16`` Net3 and latent_avg are bfloat16 (``model_io.cast_bf16``) and
every path computes the swap in the dtype of latent_avg, the masked convs
in the kernel's bf16 form; the parser, the stitch, the blend and the uint8
quantisation stay f32; the chain runs its four conv nets in bf16.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from e4s_tpu_torch.models.facevid2vid.driver import FaceVid2Vid
from e4s_tpu_torch.models.gpen.face_enhancement import FaceEnhancement
from e4s_tpu_torch.ops.resize import bilinear_resize
from e4s_tpu_torch.pipelines.model_io import (
    load_face_parser,
    load_net3,
    resolve_device,
)
from e4s_tpu_torch.pipelines.reenact_restore import DeviceReenactRestore
from e4s_tpu_torch.pipelines.swap_core import (
    lap_blend_stitch,
    make_swap_core,
    make_swap_e2e,
    parse12_host,
    stitch_foreground,
)
from e4s_tpu_torch.utils.img_utils import tensor2im, vis_mask_in_color
from e4s_tpu_torch.utils.swap_mask import swap_head_mask


def _to_chw01(img) -> np.ndarray:
    """PIL RGB -> [1,3,S,S] float32 in [0,1]."""
    return np.transpose(np.asarray(img, np.float32) / 255.0, (2, 0, 1))[None]


class FaceSwapper:
    """Holds the models on one device; call ``swap``, ``swap_from_arrays``
    or ``swap_batch``. ``device`` defaults to the GPU and raises when there
    is none. ``opts``: the fields of ``options/swap_options.py``.
    ``reenactor`` and ``restorer``: a ``FaceVid2Vid`` and a
    ``FaceEnhancement`` (``facevid2vid/driver.py::build_reenactor``,
    ``gpen/face_enhancement.py::build_restorer``), given together; their
    models run as the on-device chain in front of every swap."""

    def __init__(self, opts, device="cuda", seed: int = 0, reenactor=None,
                 restorer=None):
        self.opts = opts
        self.device = resolve_device(device)
        self.chain = None
        if reenactor is not None or restorer is not None:
            if not (isinstance(reenactor, FaceVid2Vid)
                    and isinstance(restorer, FaceEnhancement)):
                raise ValueError("FaceSwapper takes a FaceVid2Vid re-enactor and "
                                 "a FaceEnhancement restorer together "
                                 "(build_reenactor, build_restorer)")
            self.chain = DeviceReenactRestore(
                reenactor, restorer, bf16=bool(getattr(opts, "bf16", False)))
        self.net, self.latent_avg = load_net3(opts, device=self.device, seed=seed)
        self.parser = load_face_parser(
            opts, getattr(opts, "faceParsing_ckpt", None), device=self.device,
            seed=seed,
        )
        self.lap_bld = bool(getattr(opts, "lap_bld", False))
        self._swap_e2e = make_swap_e2e(
            self.net, self.parser.model, parser_size=self.parser.parser_size,
            taxonomy=self.parser.taxonomy, lap_bld=self.lap_bld,
        )
        self._swap_core = make_swap_core(self.net, from_labels=True)

    # ----------------------------- host helpers -----------------------------

    def _load(self, path) -> np.ndarray:
        from PIL import Image

        S = self.opts.out_size
        return _to_chw01(Image.open(path).convert("RGB").resize((S, S)))

    def _tensor(self, a, dtype=torch.float32):
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(a, dtype=None)).to(
            self.device, dtype)

    def _u8(self, a01):
        """[B,3,S,S] in [0,1] (numpy or a tensor) -> rounded uint8 on the
        device."""
        if isinstance(a01, torch.Tensor):
            return (a01.to(self.device) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        return self._tensor(np.clip(a01 * 255.0 + 0.5, 0, 255).astype(np.uint8),
                            torch.uint8)

    def _drive(self, s_u8, t_u8):
        """The chain, pair by pair, on uint8 [N,3,S,S] device tensors ->
        D_u8 at out_size (the SR's size, else a rounded bilinear resize)."""
        S = self.opts.out_size
        ds = []
        for i in range(s_u8.shape[0]):
            d = self.chain(s_u8[i:i + 1], t_u8[i:i + 1])
            if d.shape[-1] != S:
                d = torch.round(bilinear_resize(d.float(), (S, S))).clamp(0, 255).to(torch.uint8)
            ds.append(d)
        return torch.cat(ds)

    def _labels(self, m):
        """Label maps [B,h,w] -> int64 [B,1,h,w] on the device."""
        return self._tensor(np.asarray(m)[:, None].astype(np.int64), torch.int64)

    def _parse12(self, arr01) -> np.ndarray:
        return parse12_host(self.parser, self._tensor(arr01))

    def _save_verbose(self, save_dir, d_lab, t_lab, s_lab):
        """The five mask PNGs of ``--verbose``: both parses, the target's in
        colour, the swapped mask plain and in colour."""
        from PIL import Image

        os.makedirs(save_dir, exist_ok=True)
        T_mask, D_mask, S_mask = (np.asarray(m).astype(np.uint8)
                                  for m in (t_lab, d_lab, s_lab))
        for name, arr in (("T_mask.png", T_mask), ("D_mask.png", D_mask),
                          ("T_mask_vis.png", vis_mask_in_color(T_mask)),
                          ("swappedMask.png", S_mask),
                          ("swappedMaskVis.png", vis_mask_in_color(S_mask))):
            Image.fromarray(arr).save(os.path.join(save_dir, name))

    # --------------------------------- main ---------------------------------

    def swap(self, source: str, target: str, save_dir: Optional[str] = None,
             target_mask: Optional[np.ndarray] = None, need_crop: bool = False,
             verbose: bool = False, only_target_crop: bool = False,
             landmarks: Optional[list] = None):
        """Swap the face in image file ``source`` onto ``target``. Without a
        crop both are resized to out_size. With ``need_crop`` (both) or
        ``only_target_crop`` the faces are aligned first (dlib, or the
        68-point ``landmarks`` of the cropped files in order) and the result
        is pasted back into the target's original frame. Returns the PIL
        image; saves it as ``swap_<source>_to_<target>.png`` under
        ``save_dir`` if given."""
        from PIL import Image

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        result_name = "swap_%s_to_%s.png" % (
            os.path.basename(source).split(".")[0],
            os.path.basename(target).split(".")[0],
        )
        cropped = only_target_crop or need_crop
        if cropped:
            from e4s_tpu_torch.utils.alignment import crop_and_align_face

            files = [(os.path.basename(f).split(".")[0], f) for f in (source, target)]
            crops, orig_images, _, inv_transforms = crop_and_align_face(
                files[1:] if only_target_crop else files,
                image_size=self.opts.out_size, landmarks=landmarks,
            )
            crops = [_to_chw01(c.convert("RGB")) for c in crops]
            if only_target_crop:
                S01, T01 = self._load(source), crops[0]
            else:
                S01, T01 = crops
        else:
            S01, T01 = self._load(source), self._load(target)

        result = self.swap_from_arrays(S01, T01, target_mask=target_mask,
                                       save_dir=save_dir, verbose=verbose)
        if cropped:
            coeffs, orig_image = inv_transforms[-1], orig_images[-1]
            swapped_rgba = result.convert("RGBA")
            swapped_rgba.putalpha(255)
            projected = swapped_rgba.transform(
                orig_image.size, Image.PERSPECTIVE, coeffs, Image.BILINEAR)
            result = orig_image.convert("RGBA")
            result.alpha_composite(projected)
        if save_dir:
            result.save(os.path.join(save_dir, result_name))
        return result

    def swap_from_arrays(self, S01: np.ndarray, T01: np.ndarray,
                         target_mask: Optional[np.ndarray] = None,
                         save_dir: Optional[str] = None, verbose: bool = False):
        """Swap the face of S01 onto T01, both [1,3,S,S] float in [0,1].
        Without ``target_mask``: two uint8 uploads, one fused pass on the
        device, one uint8 download. With ``target_mask`` (12-class labels
        at the parser's output size): the staged path. ``verbose`` writes
        the mask PNGs to ``save_dir``. Returns the result as a PIL image."""
        from PIL import Image

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        D01 = S01
        if self.chain is not None:  # the re-enacted, restored source
            D01 = self._drive(self._u8(S01), self._u8(T01)).float() / 255.0
        if target_mask is not None:
            return self._swap_staged(D01, T01, np.asarray(target_mask),
                                     save_dir if verbose else None)
        out_u8, s_lab, _, d_lab, t_lab = self._swap_e2e(
            self._u8(D01), self._u8(T01), self.latent_avg)
        if verbose and save_dir:
            self._save_verbose(save_dir, d_lab[0].cpu(), t_lab[0].cpu(),
                               s_lab[0].cpu())
        return Image.fromarray(out_u8[0].permute(1, 2, 0).cpu().numpy())

    def _swap_staged(self, S01, T01, T_mask, verbose_dir):
        """Host parse of the source and host mask swap against the caller's
        target mask, the swap core on the device, then the stitch: the
        feathered paste, or the Laplacian blend for ``lap_bld``."""
        from PIL import Image

        D_mask = self._parse12(S01)[0]
        if T_mask.shape != D_mask.shape:
            raise ValueError(f"target mask {T_mask.shape} is not the parse's "
                             f"size {D_mask.shape}")
        swapped_msk, hole_map = swap_head_mask(D_mask, T_mask)
        if verbose_dir:
            self._save_verbose(verbose_dir, D_mask, T_mask, swapped_msk)
        target_t = self._tensor(T01 * 2 - 1)
        dt = self.latent_avg.dtype
        face = self._swap_core(
            self._tensor(S01 * 2 - 1, dt), target_t.to(dt),
            self._labels(D_mask[None]), self._labels(T_mask[None]),
            self._labels(swapped_msk[None]), self.latent_avg,
        ).float()
        label_t, hole_t = self._labels(swapped_msk[None]), self._labels(hole_map[None])
        if self.lap_bld:
            blended = lap_blend_stitch(face, self._tensor(T01) * 255.0,
                                       label_t, hole_t)
            out01 = blended[0].cpu().numpy() / 255.0
            return Image.fromarray(np.transpose(
                np.clip(out01 * 255, 0, 255), (1, 2, 0)).astype(np.uint8))
        stitched = stitch_foreground(face, target_t, label_t, hole_t)
        return tensor2im(stitched[0].cpu().numpy())

    # ------------------------------ batched API -----------------------------

    def swap_batch(self, source_arrays, target_arrays, target_masks=None,
                   chunk: int = 8):
        """Swap N (source, target) pairs, [N,3,S,S] each: uint8 in gives
        uint8 out, float in [0,1] gives float in [0,1]. Without target masks
        the pairs go through the fused pass ``chunk`` at a time, the last
        chunk padded by repeating its last pair (one shape for every chunk;
        the ear and mouth fallbacks of the texture swap are decided over a
        chunk, padding included, as in the JAX package). With
        ``target_masks`` [N,h,w] (float images only) the staged path runs
        over the whole batch with the feathered stitch. With the chain, each
        pair is re-enacted and restored first (uint8 images go to it as
        they are)."""
        src, tgt = np.asarray(source_arrays), np.asarray(target_arrays)
        u8_in = src.dtype == np.uint8 and tgt.dtype == np.uint8
        if target_masks is not None:
            if u8_in:
                raise ValueError("target masks take float images in [0,1]")
            S01, T01 = src.astype(np.float32), tgt.astype(np.float32)
            if self.chain is not None:
                S01 = self._drive(self._u8(S01), self._u8(T01)).float() / 255.0
            return self._swap_batch_staged(S01, T01, np.asarray(target_masks))
        n = src.shape[0]
        chunk = min(chunk, n)
        outs = []
        for lo in range(0, n, chunk):
            s, t = src[lo:lo + chunk], tgt[lo:lo + chunk]
            if not u8_in:
                s, t = (np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
                        for a in (s, t))
            s, t = self._tensor(s, torch.uint8), self._tensor(t, torch.uint8)
            if self.chain is not None:
                s = self._drive(s, t)
            if len(s) < chunk:
                rep = chunk - len(s)
                s = torch.cat([s, s[-1:].expand(rep, -1, -1, -1)])
                t = torch.cat([t, t[-1:].expand(rep, -1, -1, -1)])
            out_u8 = self._swap_e2e(s, t, self.latent_avg)[0]
            outs.append(out_u8.cpu().numpy())
        res = np.concatenate(outs)[:n]
        return res if u8_in else res.astype(np.float32) / 255.0

    def _swap_batch_staged(self, S01, T01, T_masks):
        D_masks = self._parse12(S01)
        swapped, holes = zip(*(swap_head_mask(d, t) for d, t in zip(D_masks, T_masks)))
        swapped_msk, hole_map = np.stack(swapped), np.stack(holes)
        target_t = self._tensor(T01 * 2 - 1)
        dt = self.latent_avg.dtype
        faces = self._swap_core(
            self._tensor(S01 * 2 - 1, dt), target_t.to(dt),
            self._labels(D_masks), self._labels(T_masks),
            self._labels(swapped_msk), self.latent_avg,
        ).float()
        stitched = stitch_foreground(faces, target_t, self._labels(swapped_msk),
                                     self._labels(hole_map))
        return np.clip((stitched.cpu().numpy() + 1) / 2, 0, 1)


def faceSwapping_pipeline(source, target, opts, save_dir, target_mask=None,
                          need_crop=False, verbose=False, only_target_crop=False,
                          reenactor=None, restorer=None, device="cuda"):
    """The reference's functional entry (``scripts/face_swap.py``):
    ``FaceSwapper(opts, device, reenactor=, restorer=).swap(...)``; the
    re-enactor and the restorer are the port's ``FaceVid2Vid`` and
    ``FaceEnhancement``, given together or not at all."""
    swapper = FaceSwapper(opts, device=device, reenactor=reenactor, restorer=restorer)
    return swapper.swap(source, target, save_dir=save_dir, target_mask=target_mask,
                        need_crop=need_crop, verbose=verbose,
                        only_target_crop=only_target_crop)
