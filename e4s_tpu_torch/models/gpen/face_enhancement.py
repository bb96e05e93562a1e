"""GPEN blind face restoration: the four nets and the settings of the
reference's FaceEnhancement (counterpart of
``e4s_tpu/models/gpen/face_enhancement.py``). The detect, align, restore and
paste steps run on the device in ``pipelines/reenact_restore.py``; this
module holds no cv2 glue.
"""

from __future__ import annotations

import os

import torch

from e4s_tpu_torch.models.gpen.align_faces import get_reference_facial_points
from e4s_tpu_torch.models.gpen.gpen_model import GPENFullGenerator
from e4s_tpu_torch.models.gpen.parsenet import ParseNet
from e4s_tpu_torch.models.gpen.retinaface import RetinaFace
from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet

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


class FaceEnhancement:
    """``facegan`` (GPEN at ``in_size``), ``srmodel`` (RealESRNet),
    ``faceparser`` (ParseNet at ``in_size``), ``facedetector`` (RetinaFace),
    the detection threshold and the five reference points of the crop.

    ``force_one_face``: when no face is detected, one centred box with
    canonical landmarks stands in, so that the restore step runs with random
    weights (which detect nothing). It is refused with a loaded RetinaFace
    checkpoint, where it would paste a made-up face."""

    threshold = 0.9

    def __init__(self, facegan, srmodel, faceparser, facedetector,
                 in_size: int = 512, use_sr: bool = True,
                 force_one_face: bool = False, detector_loaded: bool = False):
        if force_one_face and detector_loaded:
            raise ValueError(FORCE_ONE_FACE_REFUSED)
        self.facegan = facegan
        self.srmodel = srmodel
        self.faceparser = faceparser
        self.facedetector = facedetector
        self.in_size = in_size
        self.use_sr = use_sr
        self.force_one_face = force_one_face
        self.reference_5pts = get_reference_facial_points(
            (in_size, in_size), 0.25, (0, 0), True)


def _load(path, entry):
    from e4s_tpu_torch.pipelines.model_io import _strip_module

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if entry and entry in sd:
        sd = sd[entry]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return _strip_module(sd)


def build_restorer(model_params: dict, device="cuda", seed: int = 0):
    """The ``FaceEnhancement`` on ``device``. ``model_params``: the
    reference's GPEN settings (``base_dir``, ``in_size``, ``use_sr``,
    ``sr_scale``, ``channel_multiplier``, ``narrow``, ``force_one_face``).
    Each net takes its reference checkpoint under ``base_dir/weights`` when
    the file exists, else seeded random weights."""
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
        "facegan": lambda: GPENFullGenerator(
            in_size, channel_multiplier=p.get("channel_multiplier", 2),
            narrow=p.get("narrow", 1)),
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
                           detector_loaded="retinaface" in sds)
