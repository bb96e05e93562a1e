"""The re-enact -> restore chain in plain PyTorch, every uint8 quantisation
of the original host glue kept where it happens:

  S_u8, T_u8 -> /255 -> anti-aliased resize to FaceVid2Vid's size -> kp
  detector, head pose, keypoint transformation -> the generator -> truncate
  to uint8 -> RealESRNet x4 (rounded) and the rounded bilinear upsample ->
  RetinaFace on the upsample -> NMS and the similarity fits on the host
  (``force_one_face``: a centred stand-in when nothing is found) -> per
  face: affine crop (rounded) -> GPEN (truncated) -> ParseNet mask,
  borders zeroed, double Gaussian feather, warped back -> composited over
  the SR image, truncated.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models.gpen.align_faces import (
    get_reference_facial_points,
    invert_affine,
    similarity_pair,
)
from benchmark.reference.models.gpen.parsenet import parse_mask
from benchmark.reference.models.gpen.retinaface import detect_on_device, select_detections
from benchmark.reference.ops.resize import antialiased_resize, bilinear_resize, resize_u8
from benchmark.reference.ops.warp import affine_warp, filter2d_sharpen_u8, gaussian_blur_cv2

NMS_THRESHOLD = 0.4
TOP_K, KEEP_TOP_K = 5000, 750  # the reference detector's defaults
SMALL_FACE_PX = 100  # faces narrower than this are sharpened before the paste
MASK_BORDER = 20  # rows/columns of the parse mask zeroed before the feather
# force_one_face's stand-in: a centred box of half the image, and the five
# landmarks (eyes, nose, mouth corners) as fractions of that box
ONE_FACE_PTS = np.array([[0.38, 0.62, 0.50, 0.40, 0.60],   # x
                         [0.42, 0.42, 0.55, 0.70, 0.70]])  # y


def _u8_trunc(x):
    """float -> uint8 as numpy's astype after a clip: truncation."""
    return x.clamp(0, 255).to(torch.uint8)


def _u8_round(x):
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _bilinear_u8(img_u8, size):
    """Float bilinear resize, rounded half to even."""
    return _u8_round(bilinear_resize(img_u8.float(), size))


def _hw(size):
    """An int side or an (H, W) pair -> (H, W)."""
    return (size, size) if isinstance(size, int) else tuple(size)


def gan_u8(gan, img_u8, act=torch.float32):
    """The reference's ``FaceGAN`` on RGB uint8 [B,3,n,n]: [-1,1] in,
    clip to [0,1], x255, truncated to uint8 (at the generator's output
    size)."""
    x = ((img_u8.float() / 255.0 - 0.5) / 0.5).to(act)
    out = gan(x).float()
    return _u8_trunc((out * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0)


def sr_u8(sr, img_u8, act=torch.float32):
    """The reference's ``RealESRNet`` on RGB uint8 [B,3,h,w]: [0,1] in,
    clipped, x255, rounded to uint8."""
    out = sr((img_u8.float() / 255.0).to(act))
    return _u8_round(out.float().clamp(0.0, 1.0) * 255.0)


def parse_u8(parser, img_u8, act=torch.float32):
    """The reference's ``FaceParse`` on RGB uint8 [B,3,h,w]: resized to the
    parser's size as cv2 does, [-1,1] in -> the paste mask [B,s,s] in
    {0, 255}, float32."""
    x = resize_u8(img_u8, (parser.in_size, parser.in_size))
    logits = parser((x.float() / 255.0 * 2.0 - 1.0).to(act))[0].float()
    return parse_mask(logits)


def mask_postprocess(mask, thres: int = MASK_BORDER):
    """The paste mask's feather: ``thres`` rows and columns at each border
    zeroed (in place), then ``cv2.GaussianBlur`` (101, sigma 11) twice."""
    mask[..., :thres, :] = 0
    mask[..., -thres:, :] = 0
    mask[..., :, :thres] = 0
    mask[..., :, -thres:] = 0
    return gaussian_blur_cv2(gaussian_blur_cv2(mask, 101, 11.0), 101, 11.0)


class Enhancer:
    """GPEN's four nets on one device, the detection threshold and the five
    reference points of the crop (GPEN's ``FaceEnhancement``)."""

    threshold = 0.9

    def __init__(self, facegan, srmodel, faceparser, facedetector,
                 in_size: int = 512, force_one_face: bool = True):
        self.facegan = facegan
        self.srmodel = srmodel
        self.faceparser = faceparser
        self.facedetector = facedetector
        self.in_size = in_size
        self.use_sr = True
        self.force_one_face = force_one_face
        self.reference_5pts = get_reference_facial_points(
            (in_size, in_size), 0.25, (0, 0), True)


class DeviceRestore:
    """GPEN's unaligned restoration on RGB uint8 [1,3,H,W] tensors.
    ``enhancer``: an ``Enhancer``."""

    def __init__(self, enhancer):
        self.enh = enhancer
        self.act = torch.float32
        self.sr, self.det, self.gan, self.parser = (
            enhancer.srmodel, enhancer.facedetector, enhancer.facegan,
            enhancer.faceparser)
        self.last_faces = None

    # ------------------------------ stages ------------------------------

    _upsample = staticmethod(resize_u8)  # the glue's cv2.resize to the SR's size

    def _sr_u8(self, img_u8):
        """uint8 [1,3,h,w] -> (img_sr_u8, img_up_u8) at the SR's size: the
        SR (rounded) and the input resized to its size."""
        img_sr_u8 = sr_u8(self.sr, img_u8, self.act)
        return img_sr_u8, self._upsample(img_u8, tuple(img_sr_u8.shape[-2:]))

    def _det_stage(self, img_up_u8):
        """RetinaFace on the image (BGR less the mean) -> every prior's
        decoded (boxes [P,4], landmarks [P,10], face scores [P]) in
        pixels."""
        return detect_on_device(self.det, img_up_u8.float().flip(1), self.act)

    def _faces(self, boxes, lms, scores, size):
        """Download the candidates above the threshold; NMS; the stand-in
        face of ``force_one_face``. Returns [(minv_crop, minv_back, small)]
        in NMS order: the destination-to-source maps of the crop and of the
        paste ([2,3] on the scores' device, copied there together), and
        whether the face is under 100 px. ``size``: the image's side or
        (H, W)."""
        h, w = _hw(size)
        dets, lms_k = select_detections(boxes, lms, scores, self.enh.threshold,
                                        NMS_THRESHOLD, TOP_K, KEEP_TOP_K)
        if self.enh.force_one_face and len(dets) == 0:
            dets = np.array([[w * 0.25, h * 0.25, w * 0.75, h * 0.75, 1.0]], np.float32)
            lms_k = np.stack([w * (0.25 + 0.5 * ONE_FACE_PTS[0]),
                              h * (0.25 + 0.5 * ONE_FACE_PTS[1])]).reshape(1, 10)
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

    def _restore_face(self, img_up_u8, minv_crop, minv_back, small, size, crops=None):
        """One face -> (its feathered mask [H,W], the restored face warped
        back and rounded [3,H,W]), float32. ``crops``: a list that takes
        (the crop, GPEN's face), uint8 [3,n,n] and [3,N,N]."""
        h, w = _hw(size)
        n = self.enh.in_size
        of_u8 = _u8_round(affine_warp(img_up_u8[0].float(), minv_crop, (n, n)))
        ef_u8 = gan_u8(self.gan, of_u8[None], self.act)[0]
        if crops is not None:
            crops.append((of_u8, ef_u8))
        m = mask_postprocess(parse_u8(self.parser, ef_u8[None], self.act)[0] / 255.0)
        m_full = affine_warp(bilinear_resize(m[None], (n, n)), minv_back, (h, w))[0]
        if small:
            ef_u8 = filter2d_sharpen_u8(ef_u8)
        ef_u8 = resize_u8(ef_u8, (n, n))
        ef_warp = torch.round(affine_warp(ef_u8.float(), minv_back, (h, w))).clamp(0, 255)
        return m_full, ef_warp

    def _restore_stage(self, img_up_u8, img_sr_u8, faces, crops=None):
        """Restore each face and composite it over the SR image: a face
        replaces the pixels where its mask exceeds the mask of the faces
        before it; then base * (1 - mask) + faces * mask, truncated."""
        h, w = img_sr_u8.shape[-2:]
        full_mask = torch.zeros((h, w), device=img_sr_u8.device)
        full_img = torch.zeros((3, h, w), device=img_sr_u8.device)
        for minv_crop, minv_back, small in faces:
            m, img = self._restore_face(img_up_u8, minv_crop, minv_back, small,
                                        (h, w), crops)
            sel = (m - full_mask) > 0
            full_mask = torch.where(sel, m, full_mask)
            full_img = torch.where(sel[None], img, full_img)
        base = img_sr_u8[0].float()
        return _u8_trunc(base * (1.0 - full_mask) + full_img * full_mask)[None]

    def _restore_faces(self, img_sr_u8, img_up_u8, crops=None):
        """Detect on ``img_up_u8``, restore every face from it and paste
        them over ``img_sr_u8`` (returned as it is when there is none)."""
        boxes, lms, scores = self._det_stage(img_up_u8)
        faces = self._faces(boxes, lms, scores, tuple(img_up_u8.shape[-2:]))
        self.last_faces = faces
        if not faces:
            return img_sr_u8
        return self._restore_stage(img_up_u8, img_sr_u8, faces, crops)


class DeviceReenactRestore(DeviceRestore):
    """Callable (S_u8, T_u8 [1,3,H,W] uint8 on the device) -> D_u8
    [1,3,S,S] uint8 on the device, S the SR's output size. ``fv2v``:
    ``models/facevid2vid/driver.py::FaceVid2Vid``; ``enhancer``:
    ``models/gpen/face_enhancement.py::FaceEnhancement`` with its SR on."""

    def __init__(self, fv2v, enhancer):
        super().__init__(enhancer)
        self.fv2v = fv2v

    # the chain's upsample of the prediction: a rounded bilinear resize
    _upsample = staticmethod(_bilinear_u8)

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
        return self._sr_u8(_u8_trunc(pred * 255.0))

    # ------------------------------ driver ------------------------------

    @torch.no_grad()
    def restore(self, pred):
        """pred [1,3,h,w] in [0,1] -> D_u8 [1,3,4h,4w]: SR, detect, restore."""
        return self._restore_faces(*self._sr_stage(pred))

    @torch.no_grad()
    def __call__(self, s_u8, t_u8):
        s, kp_d, kp_s = self._prep_pose(s_u8, t_u8)
        return self.restore(self._generate(s, kp_d, kp_s))
