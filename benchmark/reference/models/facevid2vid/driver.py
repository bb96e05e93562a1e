"""FaceVid2Vid driving (vox-256, no jacobians, the SPADE generator): the
keypoint transformation and the head pose."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models.facevid2vid.generator import OcclusionAwareSPADEGenerator
from benchmark.reference.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector


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
    one device; ``size`` is the side they run at (256 for vox-256)."""

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
