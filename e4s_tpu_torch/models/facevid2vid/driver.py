"""FaceVid2Vid driving: the keypoint transformation, the re-enactor and
its driving API (counterpart of ``e4s_tpu/models/facevid2vid/driver.py``;
vox-256, no jacobians, the SPADE generator)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from e4s_tpu_torch.models.facevid2vid.generator import OcclusionAwareSPADEGenerator
from e4s_tpu_torch.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector
from e4s_tpu_torch.ops.resize import antialiased_resize


def headpose_pred_to_degree(pred):
    """66-bin logits -> degrees (softmax expectation * 3 - 99)."""
    idx = torch.arange(pred.shape[-1], dtype=pred.dtype, device=pred.device)
    return (F.softmax(pred, dim=-1) * idx).sum(dim=1) * 3 - 99


def get_rotation_matrix(yaw, pitch, roll):
    """pitch @ yaw @ roll from degrees, with pi taken as 3.14 as the
    reference does."""
    yaw, pitch, roll = (a / 180 * 3.14 for a in (yaw, pitch, roll))
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)

    def mat(*entries):
        return torch.stack(entries, dim=1).reshape(-1, 3, 3)

    pitch_mat = mat(o, z, z, z, torch.cos(pitch), -torch.sin(pitch),
                    z, torch.sin(pitch), torch.cos(pitch))
    yaw_mat = mat(torch.cos(yaw), z, torch.sin(yaw), z, o, z,
                  -torch.sin(yaw), z, torch.cos(yaw))
    roll_mat = mat(torch.cos(roll), -torch.sin(roll), z,
                   torch.sin(roll), torch.cos(roll), z, z, z, o)
    return torch.einsum("bij,bjk,bkm->bim", pitch_mat, yaw_mat, roll_mat)


def keypoint_transformation(kp_canonical, he):
    """Canonical keypoints posed by a head pose: R kp + t + expression."""
    kp = kp_canonical["value"]
    rot = get_rotation_matrix(headpose_pred_to_degree(he["yaw"]),
                              headpose_pred_to_degree(he["pitch"]),
                              headpose_pred_to_degree(he["roll"]))
    kp_t = torch.einsum("bmp,bkp->bkm", rot, kp) + he["t"][:, None, :]
    return {"value": kp_t + he["exp"].reshape(he["exp"].shape[0], -1, 3)}


class FaceVid2Vid:
    """The three nets (``kp_detector``, ``he_estimator``, ``generator``) on
    one device; ``size`` is the side they run at (256 for vox-256). The
    swap's on-device chain (``pipelines/reenact_restore.py``) drives them
    through ``pose`` and ``generator``; ``drive`` and ``reenact`` are the
    JAX package's driving API, and ``reenact`` is the callable that its
    ``build_reenactor`` returns."""

    def __init__(self, kp_detector, he_estimator, generator, size: int = 256):
        self.kp_detector = kp_detector
        self.he_estimator = he_estimator
        self.generator = generator
        self.size = size

    def pose(self, s, t):
        """s, t [B,3,size,size] in [0,1] -> (kp_driving, kp_source): the
        canonical keypoints of s posed by t's and by s's own head pose."""
        kp_c = self.kp_detector(s)
        kp_s = keypoint_transformation(kp_c, self.he_estimator(s))
        kp_d = keypoint_transformation(kp_c, self.he_estimator(t))
        return kp_d, kp_s

    @torch.no_grad()
    def _drive(self, source, driving):
        """source, driving [B,3,size,size] in [0,1] -> the prediction
        [B,3,size,size]: the source's keypoints posed by the driving head
        pose, through the generator."""
        kp_d, kp_s = self.pose(source, driving)
        return self.generator(source, kp_d, kp_s)["prediction"]

    def drive(self, source01, driving01):
        """[B,3,H,W] in [0,1] (numpy or tensors) at any size -> the driven
        [B,3,size,size] in [0,1] on the nets' device; both are resized to
        ``size`` with skimage's anti-aliasing, as the reference does."""
        dev = next(self.generator.parameters()).device
        size = (self.size, self.size)
        s, d = (antialiased_resize(torch.as_tensor(a).to(dev, torch.float32), size)
                for a in (source01, driving01))
        return self._drive(s, d)

    def reenact(self, S01, T01) -> np.ndarray:
        """The JAX ``build_reenactor`` callable: (S01, T01 [1,3,H,W] in
        [0,1]) -> D01 [1,3,size,size] float32 numpy."""
        return self.drive(S01, T01).cpu().numpy()


def drive_source(model: FaceVid2Vid, source01, driving_list):
    """The source driven by each frame of ``driving_list``: a list of
    [B,3,size,size] float32 numpy predictions."""
    return [model.reenact(source01, d) for d in driving_list]


def build_reenactor(ckpt_path: Optional[str] = None, device="cuda", seed: int = 0,
                    size: int = 256, kp_kwargs=None, gen_kwargs=None):
    """The ``FaceVid2Vid`` on ``device`` (its ``reenact`` method is the
    callable of the JAX ``build_reenactor``). The nets take the reference
    checkpoint's ``kp_detector``, ``he_estimator`` and ``generator``
    state_dicts when ``ckpt_path`` exists, else seeded random weights;
    ``kp_kwargs`` and ``gen_kwargs`` narrow them (tests)."""
    from e4s_tpu_torch.pipelines.model_io import _strip_module, materialise

    sds = {}
    if ckpt_path and os.path.exists(ckpt_path):
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sds = {k: _strip_module(ckpt[k])
               for k in ("kp_detector", "he_estimator", "generator")}
    nets = [materialise(lambda c=cls, kw=kw: c(**(kw or {})), sds.get(key),
                        seed + i, device)
            for i, (key, cls, kw) in enumerate((
                ("kp_detector", KPDetector, kp_kwargs),
                ("he_estimator", HEEstimator, None),
                ("generator", OcclusionAwareSPADEGenerator, gen_kwargs)))]
    return FaceVid2Vid(*nets, size=size)
