"""GPEN blind face restoration (counterpart of
``e4s_tpu/models/gpen/face_enhancement.py``): the reference's wrappers
``FaceGAN``, ``RealESRNet`` and ``FaceParse`` and its ``FaceEnhancement``,
each with ``process`` on BGR uint8 images of any size, computed on the
nets' device. ``FaceEnhancement.process`` runs the restoration steps that
the swap's re-enact -> restore chain runs
(``pipelines/reenact_restore.py::DeviceRestore``); this module holds no
cv2 glue.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from e4s_tpu_torch.models.gpen.align_faces import get_reference_facial_points
from e4s_tpu_torch.models.gpen.gpen_model import GPENFullGenerator, GPENFullGeneratorSR
from e4s_tpu_torch.models.gpen.parsenet import ParseNet
from e4s_tpu_torch.models.gpen.retinaface import RetinaFace
from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
from e4s_tpu_torch.ops.resize import resize_u8
from e4s_tpu_torch.pipelines.reenact_restore import (
    MASK_BORDER,
    DeviceRestore,
    gan_u8,
    mask_postprocess,
    parse_u8,
    sr_u8,
)

# reference checkpoint files under <base_dir>/weights/, and the entry of
# the file that holds the state_dict (None: the file is the state_dict)
GPEN_CHECKPOINTS = {
    "facegan": ("GPEN-BFR-512.pth", None),
    "srmodel": ("realesrnet_x4.pth", "params_ema"),
    "parsenet": ("ParseNet-latest.pth", None),
    "retinaface": ("RetinaFace-R50.pth", None),
}


FORCE_ONE_FACE_REFUSED = ("force_one_face is for random-weight runs; it must "
                          "not be combined with real RetinaFace weights")


def bgr_to_u8(img_bgr, device) -> torch.Tensor:
    """[H,W,3] BGR uint8 (numpy) -> [1,3,H,W] RGB uint8 on ``device``."""
    rgb = np.ascontiguousarray(np.asarray(img_bgr, np.uint8)[:, :, ::-1].transpose(2, 0, 1))
    return torch.from_numpy(rgb)[None].to(device)


def u8_to_bgr(img_u8) -> np.ndarray:
    """[1,3,H,W] (or [3,H,W]) RGB uint8 tensor -> [H,W,3] BGR uint8 numpy."""
    t = img_u8[0] if img_u8.ndim == 4 else img_u8
    return np.ascontiguousarray(t.flip(0).permute(1, 2, 0).cpu().numpy())


def _net(build, net, device, seed):
    """``net``, or ``build()`` with seeded random weights on ``device``."""
    if net is not None:
        return net
    from e4s_tpu_torch.pipelines.model_io import materialise, resolve_device

    return materialise(build, None, seed, resolve_device(device))


def build_gpen(in_size=512, out_size=None, channel_multiplier=2, narrow=1.0):
    """GPEN at ``in_size``: ``GPENFullGeneratorSR`` when ``out_size`` is
    above it, as the reference's FaceGAN builds it, else
    ``GPENFullGenerator``."""
    if out_size is None or out_size == in_size:
        return GPENFullGenerator(in_size, channel_multiplier=channel_multiplier,
                                 narrow=narrow)
    return GPENFullGeneratorSR(in_size, out_size, channel_multiplier=channel_multiplier,
                               narrow=narrow)


class FaceGAN:
    """GPEN on one face. ``process``: BGR uint8 [H,W,3] -> resized to
    ``in_size`` (cv2's uint8 resize) -> restored BGR uint8 at ``out_size``.
    ``net``: a GPEN generator; without one, seeded random weights on
    ``device``."""

    def __init__(self, in_size=512, out_size=None, net=None, device="cuda",
                 channel_multiplier=2, narrow=1.0, seed: int = 0):
        self.in_size = in_size
        self.out_size = in_size if out_size is None else out_size
        self.model = _net(lambda: build_gpen(in_size, self.out_size, channel_multiplier,
                                             narrow), net, device, seed)

    @torch.no_grad()
    def process(self, img_bgr) -> np.ndarray:
        p = next(self.model.parameters())
        x = resize_u8(bgr_to_u8(img_bgr, p.device), (self.in_size, self.in_size))
        return u8_to_bgr(gan_u8(self.model, x, p.dtype))


class RealESRNet:
    """RealESRNet (x``scale``). ``process``: BGR uint8 [H,W,3] -> BGR uint8
    [scale H, scale W, 3], rounded. ``net``: an ``RRDBNet``; without one,
    seeded random weights on ``device``."""

    def __init__(self, scale=4, net=None, device="cuda", seed: int = 0):
        self.scale = scale
        self.model = _net(lambda: RRDBNet(scale=scale), net, device, seed)

    @torch.no_grad()
    def process(self, img_bgr) -> np.ndarray:
        p = next(self.model.parameters())
        return u8_to_bgr(sr_u8(self.model, bgr_to_u8(img_bgr, p.device), p.dtype))


class FaceParse:
    """ParseNet. ``process``: BGR uint8 [H,W,3] -> resized to the net's
    ``size`` (cv2's uint8 resize) -> the paste mask [1,size,size] uint8 in
    {0, 255}. ``net``: a ``ParseNet``; without one, the reference's (512)
    with seeded random weights on ``device``."""

    def __init__(self, net=None, device="cuda", seed: int = 0):
        self.model = _net(ParseNet, net, device, seed)
        self.size = self.model.in_size

    @torch.no_grad()
    def process(self, img_bgr) -> np.ndarray:
        p = next(self.model.parameters())
        m = parse_u8(self.model, bgr_to_u8(img_bgr, p.device), p.dtype)
        return m.to(torch.uint8).cpu().numpy()


class FaceEnhancement:
    """``facegan`` (GPEN from ``in_size`` to ``out_size``), ``srmodel``
    (RealESRNet), ``faceparser`` (ParseNet), ``facedetector`` (RetinaFace),
    the detection threshold and the five reference points of the crop; the
    nets live on one device.

    ``force_one_face``: when no face is detected, one centred box with
    canonical landmarks stands in, so that the restore step runs with random
    weights (which detect nothing). It is refused with a loaded RetinaFace
    checkpoint, where it would paste a made-up face."""

    threshold = 0.9

    def __init__(self, facegan, srmodel, faceparser, facedetector,
                 in_size: int = 512, use_sr: bool = True,
                 force_one_face: bool = False, detector_loaded: bool = False,
                 out_size: int = None):
        if force_one_face and detector_loaded:
            raise ValueError(FORCE_ONE_FACE_REFUSED)
        self.facegan = facegan
        self.srmodel = srmodel
        self.faceparser = faceparser
        self.facedetector = facedetector
        self.in_size = in_size
        self.out_size = in_size if out_size is None else out_size
        self.use_sr = use_sr
        self.force_one_face = force_one_face
        self.reference_5pts = get_reference_facial_points(
            (in_size, in_size), 0.25, (0, 0), True)

    @staticmethod
    def mask_postprocess(mask, thres: int = MASK_BORDER):
        """A paste mask [H,W] in [0,1] (numpy or a tensor; changed in
        place) -> its feather: ``thres`` rows and columns at each border
        zeroed, then two 101-tap Gaussian blurs (sigma 11). float32."""
        if isinstance(mask, torch.Tensor):
            return mask_postprocess(mask, thres).float()
        return mask_postprocess(torch.from_numpy(mask), thres).numpy().astype(np.float32)

    @torch.no_grad()
    def process(self, img, aligned: bool = False):
        """The reference's ``FaceEnhancement.process`` on a BGR uint8
        [H,W,3] image, on the nets' device.

        Unaligned: the SR of the image (with ``use_sr``); every face
        RetinaFace finds in the image resized to the SR's size is cropped,
        restored by GPEN and pasted back under its feathered ParseNet mask.
        Aligned: GPEN on the whole image resized to ``in_size``, then the
        SR. Returns (the result BGR uint8, the face crops, GPEN's faces),
        the last two BGR uint8 lists of one entry per face."""
        dev = next(self.facegan.parameters()).device
        x = bgr_to_u8(img, dev)
        restore = DeviceRestore(self)
        if aligned:
            out, ef = restore.process_aligned_u8(x)
            return u8_to_bgr(out), [np.asarray(img)], [u8_to_bgr(ef)]
        out, crops = restore.process_u8(x)
        return (u8_to_bgr(out), [u8_to_bgr(of) for of, _ in crops],
                [u8_to_bgr(ef) for _, ef in crops])


def gpen_demo(img_bgr, model: FaceEnhancement, aligned: bool = False):
    """The restored BGR uint8 image of ``model.process``."""
    out, _, _ = model.process(img_bgr, aligned=aligned)
    return out


def _load(path, entry):
    from e4s_tpu_torch.pipelines.model_io import _strip_module

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if entry and entry in sd:
        sd = sd[entry]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return _strip_module(sd)


def build_restorer(model_params: dict, device="cuda", seed: int = 0,
                   out_size: int = None):
    """The ``FaceEnhancement`` on ``device``. ``model_params``: the
    reference's GPEN settings (``base_dir``, ``in_size``, ``use_sr``,
    ``sr_scale``, ``channel_multiplier``, ``narrow``, ``force_one_face``).
    ParseNet runs at ``in_size`` (the reference's FaceParse at 512, the
    same for GPEN-512). ``out_size`` above ``in_size`` builds
    ``GPENFullGeneratorSR``, as the
    reference's FaceGAN does. Each net takes its reference checkpoint under
    ``base_dir/weights`` when the file exists, else seeded random
    weights."""
    from e4s_tpu_torch.pipelines.model_io import materialise

    p = model_params
    in_size = p.get("in_size", 512)
    force_one_face = p.get("force_one_face", False)
    sds = {}
    if p.get("base_dir"):
        for key, (name, entry) in GPEN_CHECKPOINTS.items():
            path = os.path.join(p["base_dir"], "weights", name)
            if os.path.exists(path):
                sds[key] = _load(path, entry)
    if force_one_face and "retinaface" in sds:
        raise ValueError(FORCE_ONE_FACE_REFUSED)
    makers = {
        "facegan": lambda: build_gpen(in_size, out_size, p.get("channel_multiplier", 2),
                                      p.get("narrow", 1)),
        "srmodel": lambda: RRDBNet(scale=p.get("sr_scale", 4)),
        "parsenet": lambda: ParseNet(in_size, in_size),
        "retinaface": lambda: RetinaFace(),
    }
    nets = {key: materialise(build, sds.get(key), seed + i, device)
            for i, (key, build) in enumerate(makers.items())}
    return FaceEnhancement(nets["facegan"], nets["srmodel"], nets["parsenet"],
                           nets["retinaface"], in_size=in_size,
                           use_sr=p.get("use_sr", True),
                           force_one_face=force_one_face,
                           detector_loaded="retinaface" in sds, out_size=out_size)
