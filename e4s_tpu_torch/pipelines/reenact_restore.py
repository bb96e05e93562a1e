"""The re-enact -> restore chain on the device (counterpart of
``e4s_tpu/pipelines/reenact_restore.py::DeviceReenactRestore``): the
reference's FaceVid2Vid drive and GPEN restoration
(``scripts/face_swap.py:197-209`` and GPEN's ``face_enhancement.py`` of the
reference), with every uint8 quantisation of the reference's host glue kept
where it happens:

  S_u8, T_u8 -> /255 -> skimage-style anti-aliased resize to fv2v's size
  -> kp detector, head pose, keypoint transformation          (_prep_pose)
  -> the fv2v generator                                        (_generate)
  -> truncate to uint8; RealESRNet x4, rounded; the bilinear
     upsample of the uint8 prediction, rounded                 (_sr_stage)
  -> RetinaFace on the upsample, priors decoded on the device  (_det_stage)
  -> the candidates at or above the threshold downloaded; NMS and the
     Umeyama fits on the host (a few numbers)                  (_faces)
  -> per face: affine crop (rounded) -> GPEN (truncated) -> ParseNet
     mask, double Gaussian feather, warped back; the face warped back,
     rounded, sharpened first when it is under 100 px; composited over
     the SR image in NMS order where its mask exceeds the faces before,
     then truncated                                             (_restore_stage)

The chain has no host fallback: several faces, small faces and no face are
all done here. With ``bf16`` the four conv nets (SR, RetinaFace, GPEN,
ParseNet) compute in bfloat16; FaceVid2Vid, the decode, the blurs, the
warps and every quantisation stay float32.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from e4s_tpu_torch.models.gpen.align_faces import invert_affine, similarity_pair
from e4s_tpu_torch.models.gpen.parsenet import parse_mask
from e4s_tpu_torch.models.gpen.retinaface import (
    decode_boxes,
    decode_landms,
    prior_boxes,
    py_cpu_nms,
)
from e4s_tpu_torch.ops.resize import antialiased_resize, bilinear_resize
from e4s_tpu_torch.ops.warp import affine_warp, filter2d_sharpen_u8, gaussian_blur_cv2

RETINA_MEAN_BGR = (104.0, 117.0, 123.0)
NMS_THRESHOLD = 0.4
SMALL_FACE_PX = 100  # faces narrower than this are sharpened before the paste
MASK_BORDER = 20  # rows/columns of the parse mask zeroed before the feather


@functools.lru_cache(maxsize=None)
def _det_consts(S: int, device: torch.device):
    """RetinaFace's prior boxes for an S x S image (43008 boxes at 1024^2:
    tens of ms of Python each time) and its BGR mean, on the device once per
    size and device."""
    return (torch.from_numpy(prior_boxes((S, S))).to(device),
            torch.tensor(RETINA_MEAN_BGR, device=device).reshape(1, 3, 1, 1))


def _u8_trunc(x):
    """float -> uint8 as numpy's astype after a clip: truncation."""
    return x.clamp(0, 255).to(torch.uint8)


def _u8_round(x):
    return torch.round(x).clamp(0, 255).to(torch.uint8)


class DeviceReenactRestore:
    """Callable (S_u8, T_u8 [1,3,H,W] uint8 on the device) -> D_u8
    [1,3,S,S] uint8 on the device, S the SR's output size. ``fv2v``:
    ``models/facevid2vid/driver.py::FaceVid2Vid``; ``enhancer``:
    ``models/gpen/face_enhancement.py::FaceEnhancement`` with its SR on."""

    def __init__(self, fv2v, enhancer, bf16: bool = False):
        if not enhancer.use_sr:
            raise ValueError("the chain runs GPEN with its SR model (use_sr)")
        self.fv2v = fv2v
        self.enh = enhancer
        self.act = torch.bfloat16 if bf16 else torch.float32
        nets = (enhancer.srmodel, enhancer.facedetector, enhancer.facegan,
                enhancer.faceparser)
        if bf16:
            nets = tuple(copy.deepcopy(n).to(torch.bfloat16) for n in nets)
        self.sr, self.det, self.gan, self.parser = nets
        self.last_faces = None  # the faces of the last call, for callers

    # ------------------------------ stages ------------------------------

    def _prep_pose(self, s_u8, t_u8):
        """uint8 S and T -> (s at fv2v's size in [0,1], kp_driving,
        kp_source)."""
        size = (self.fv2v.size, self.fv2v.size)
        s = antialiased_resize(s_u8.float() / 255.0, size)
        t = antialiased_resize(t_u8.float() / 255.0, size)
        kp_d, kp_s = self.fv2v.pose(s, t)
        return s, kp_d, kp_s

    def _generate(self, s, kp_d, kp_s):
        return self.fv2v.generator(s, kp_d, kp_s)["prediction"]

    def _sr_stage(self, pred):
        """pred [1,3,h,w] in [0,1] -> (img_sr_u8, img_up_u8) at the SR's
        size: the uint8 prediction (truncated) through RealESRNet (rounded),
        and its bilinear upsample (rounded)."""
        pred_u8 = _u8_trunc(pred * 255.0)
        out = self.sr((pred_u8.float() / 255.0).to(self.act))
        img_sr_u8 = _u8_round(out.float().clamp(0.0, 1.0) * 255.0)
        S = img_sr_u8.shape[-1]
        img_up_u8 = _u8_round(bilinear_resize(pred_u8.float(), (S, S)))
        return img_sr_u8, img_up_u8

    def _det_stage(self, img_up_u8):
        """RetinaFace on the upsample (BGR less the mean) -> every prior's
        decoded (boxes [P,4], landmarks [P,10], face scores [P]) in
        pixels."""
        S = img_up_u8.shape[-1]
        priors, mean = _det_consts(S, img_up_u8.device)
        x = img_up_u8.float().flip(1)
        loc, conf, ldm = (t.float()[0] for t in self.det((x - mean).to(self.act)))
        return decode_boxes(loc, priors) * S, decode_landms(ldm, priors) * S, conf[:, 1]

    def _faces(self, boxes, lms, scores, S):
        """Download the candidates at or above the threshold; NMS; the
        stand-in face of ``force_one_face``. Returns [(minv_crop,
        minv_back, small)] in NMS order: the destination-to-source maps of
        the crop and of the paste ([2,3] on the scores' device, copied there
        together), and whether the face is under 100 px."""
        keep = torch.nonzero(scores >= self.enh.threshold).flatten()
        dets = torch.cat([boxes[keep], scores[keep, None]], dim=1).cpu().numpy()
        lms_k = lms[keep].cpu().numpy()
        if len(dets):
            order = py_cpu_nms(dets, NMS_THRESHOLD)
            dets, lms_k = dets[order], lms_k[order]
        if self.enh.force_one_face and len(dets) == 0:
            dets = np.array([[S * 0.25, S * 0.25, S * 0.75, S * 0.75, 1.0]], np.float32)
            pts = np.array([[0.38, 0.62, 0.50, 0.40, 0.60],
                            [0.42, 0.42, 0.55, 0.70, 0.70]])
            lms_k = np.stack([S * (0.25 + 0.5 * pts[0]),
                              S * (0.25 + 0.5 * pts[1])]).reshape(1, 10)
        faces = []
        for det, lm in zip(dets, lms_k):
            tfm, tfm_inv = similarity_pair(np.reshape(lm, (2, 5)),
                                           self.enh.reference_5pts)
            small = min(det[3] - det[1], det[2] - det[0]) < SMALL_FACE_PX
            faces.append((invert_affine(tfm), invert_affine(tfm_inv), bool(small)))
        if not faces:
            return []
        mats = torch.from_numpy(np.stack([f[:2] for f in faces])).to(scores.device)
        return [(m[0], m[1], f[2]) for m, f in zip(mats, faces)]

    def _restore_face(self, img_up_u8, minv_crop, minv_back, small, S):
        """One face -> (its feathered mask [S,S], the restored face warped
        back and rounded [3,S,S]), float32."""
        n = self.enh.in_size
        of_u8 = _u8_round(affine_warp(img_up_u8[0].float(), minv_crop, (n, n)))
        net_in = ((of_u8.float() / 255.0 - 0.5) / 0.5).to(self.act)
        ef = self.gan(net_in[None])[0].float()
        ef_u8 = _u8_trunc((ef * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0)

        pn_in = (ef_u8.float() / 255.0 * 2.0 - 1.0).to(self.act)
        logits = self.parser(pn_in[None])[0].float()
        m = parse_mask(logits)[0] / 255.0
        b = MASK_BORDER
        m[:b, :] = 0
        m[-b:, :] = 0
        m[:, :b] = 0
        m[:, -b:] = 0
        m = gaussian_blur_cv2(gaussian_blur_cv2(m, 101, 11.0), 101, 11.0)
        m_full = affine_warp(m[None], minv_back, (S, S))[0]
        if small:
            ef_u8 = filter2d_sharpen_u8(ef_u8)
        ef_warp = torch.round(affine_warp(ef_u8.float(), minv_back, (S, S))).clamp(0, 255)
        return m_full, ef_warp

    def _restore_stage(self, img_up_u8, img_sr_u8, faces):
        """Restore each face and composite it over the SR image: a face
        replaces the pixels where its mask exceeds the mask of the faces
        before it; then base * (1 - mask) + faces * mask, truncated."""
        S = img_sr_u8.shape[-1]
        full_mask = torch.zeros((S, S), device=img_sr_u8.device)
        full_img = torch.zeros((3, S, S), device=img_sr_u8.device)
        for minv_crop, minv_back, small in faces:
            m, img = self._restore_face(img_up_u8, minv_crop, minv_back, small, S)
            sel = (m - full_mask) > 0
            full_mask = torch.where(sel, m, full_mask)
            full_img = torch.where(sel[None], img, full_img)
        base = img_sr_u8[0].float()
        return _u8_trunc(base * (1.0 - full_mask) + full_img * full_mask)[None]

    # ------------------------------ driver ------------------------------

    @torch.no_grad()
    def restore(self, pred):
        """pred [1,3,h,w] in [0,1] -> D_u8 [1,3,4h,4w]: SR, detect, restore."""
        img_sr_u8, img_up_u8 = self._sr_stage(pred)
        boxes, lms, scores = self._det_stage(img_up_u8)
        faces = self._faces(boxes, lms, scores, img_sr_u8.shape[-1])
        self.last_faces = faces
        if not faces:
            return img_sr_u8
        return self._restore_stage(img_up_u8, img_sr_u8, faces)

    @torch.no_grad()
    def __call__(self, s_u8, t_u8):
        s, kp_d, kp_s = self._prep_pose(s_u8, t_u8)
        return self.restore(self._generate(s, kp_d, kp_s))
