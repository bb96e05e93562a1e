"""RetinaFace with a ResNet-50 trunk, its FPN and SSH heads, the prior box
decoding and NMS (cfg_re50: 2 anchors on each of 3 scales)."""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm
from benchmark.reference.ops.resize import nearest_resize

RETINA_MEAN_BGR = (104.0, 117.0, 123.0)

CFG_RE50 = {
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
}


class Bottleneck(nn.Module):
    """torchvision's ResNet-50 bottleneck."""

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class ResNet50Trunk(nn.Module):
    """Up to layer4; forward returns (layer2, layer3, layer4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            layer = nn.Sequential(*[
                Bottleneck(inplanes if b == 0 else planes * 4, planes,
                           stride if b == 0 else 1, downsample=b == 0)
                for b in range(blocks)])
            setattr(self, f"layer{li + 1}", layer)
            inplanes = planes * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        f1 = self.layer1(x)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        return f2, f3, self.layer4(f3)


def conv_bn(inp, oup, kernel_size=3, leaky=0.0):
    """The reference's conv_bn / conv_bn1X1 / conv_bn_no_relu as one
    Sequential (``0`` conv, ``1`` BN[, ``2`` activation])."""
    layers = [nn.Conv2d(inp, oup, kernel_size, 1, 1 if kernel_size == 3 else 0,
                        bias=False), FrozenBatchNorm(oup)]
    if leaky is not None:
        layers.append(nn.LeakyReLU(leaky) if leaky > 0 else nn.ReLU())
    return nn.Sequential(*layers)


class SSH(nn.Module):
    def __init__(self, in_channel=256, out_channel=256):
        super().__init__()
        oc = out_channel
        self.conv3X3 = conv_bn(in_channel, oc // 2, leaky=None)
        self.conv5X5_1 = conv_bn(in_channel, oc // 4)
        self.conv5X5_2 = conv_bn(oc // 4, oc // 4, leaky=None)
        self.conv7X7_2 = conv_bn(oc // 4, oc // 4)
        self.conv7x7_3 = conv_bn(oc // 4, oc // 4, leaky=None)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7_2 = self.conv7X7_2(c5_1)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1),
                                 self.conv7x7_3(c7_2)], dim=1))


class FPN(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), out_channels=256):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"output{i + 1}", conv_bn(c, out_channels, 1))
        self.merge1 = conv_bn(out_channels, out_channels)
        self.merge2 = conv_bn(out_channels, out_channels)

    def forward(self, f1, f2, f3):
        o1, o2, o3 = self.output1(f1), self.output2(f2), self.output3(f3)
        o2 = self.merge2(o2 + nearest_resize(o3, o2.shape[-2:]))
        o1 = self.merge1(o1 + nearest_resize(o2, o1.shape[-2:]))
        return o1, o2, o3


class _Head(nn.Module):
    def __init__(self, in_channels, n_out, num_anchors=2):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_channels, num_anchors * n_out, 1)
        self.n_out = n_out

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.n_out)


class RetinaFace(nn.Module):
    """forward(x [B,3,H,W] BGR minus the mean) -> (loc [B,P,4],
    conf [B,P,2] softmaxed, landmarks [B,P,10]) over the P priors."""

    def __init__(self, out_channel=256, num_anchors=2):
        super().__init__()
        self.body = ResNet50Trunk()
        self.fpn = FPN(out_channels=out_channel)
        for i in range(3):
            setattr(self, f"ssh{i + 1}", SSH(out_channel, out_channel))
        self.ClassHead = nn.ModuleList(_Head(out_channel, 2, num_anchors) for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(out_channel, 4, num_anchors) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(out_channel, 10, num_anchors)
                                          for _ in range(3))

    def forward(self, x):
        feats = self.fpn(*self.body(x))
        feats = [self.ssh1(feats[0]), self.ssh2(feats[1]), self.ssh3(feats[2])]
        bbox = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], dim=1)
        cls = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], dim=1)
        ldm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], dim=1)
        return bbox, F.softmax(cls, dim=-1), ldm


# ---------------------------------------------------------------------------
# Prior boxes, decoding and NMS (numpy)
# ---------------------------------------------------------------------------


def prior_boxes(image_size, cfg=CFG_RE50) -> np.ndarray:
    """[P,4] anchors (cx, cy, w, h) normalised to the image, in the heads'
    order."""
    h, w = image_size
    anchors = []
    for k, step in enumerate(cfg["steps"]):
        fh, fw = int(math.ceil(h / step)), int(math.ceil(w / step))
        for i, j in itertools.product(range(fh), range(fw)):
            for min_size in cfg["min_sizes"][k]:
                anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h,
                                min_size / w, min_size / h])
    out = np.array(anchors, dtype=np.float32)
    return np.clip(out, 0, 1) if cfg["clip"] else out


def decode_boxes(loc, priors, variances=(0.1, 0.2)):
    """Box offsets [P,4] against the priors -> (x1, y1, x2, y2) [P,4] in
    units of the image side (ref: utils/box_utils.py decode()); tensors."""
    ctr = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * torch.exp(loc[:, 2:] * variances[1])
    xy1 = ctr - wh / 2
    return torch.cat([xy1, xy1 + wh], dim=1)


def decode_landms(pre, priors, variances=(0.1, 0.2)):
    """Landmark offsets [P,10] -> five (x, y) [P,10] in units of the image
    side (ref: utils/box_utils.py decode_landm()); tensors."""
    return torch.cat([priors[:, :2] + pre[:, 2 * i:2 * i + 2] * variances[0] * priors[:, 2:]
                      for i in range(5)], dim=1)


def py_cpu_nms(dets, thresh):
    """Greedy NMS over [N,5] (x1, y1, x2, y2, score); the kept indices in
    descending score order."""
    x1, y1, x2, y2, scores = (dets[:, i] for i in range(5))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = (w * h) / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


# ---------------------------------------------------------------------------
# Detection: the net and the decode on the device, NMS on the host
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def det_consts(size, device: torch.device):
    """RetinaFace's prior boxes for an H x W image (43008 boxes at 1024^2:
    tens of ms of Python each time), its BGR mean and the pixel scales of
    the boxes and the landmarks, on the device once per size and device."""
    h, w = size
    return (torch.from_numpy(prior_boxes((h, w))).to(device),
            torch.tensor(RETINA_MEAN_BGR, device=device).reshape(1, 3, 1, 1),
            torch.tensor([w, h] * 2, dtype=torch.float32, device=device),
            torch.tensor([w, h] * 5, dtype=torch.float32, device=device))


def detect_on_device(net, x_bgr, act=torch.float32):
    """RetinaFace on one BGR image ``x_bgr`` [1,3,H,W] (float, 0-255) less
    the mean, computing in ``act`` -> every prior's (boxes [P,4] and
    landmarks [P,10] in pixels, face scores [P]), float32 on the device."""
    priors, mean, box_scale, lm_scale = det_consts(tuple(x_bgr.shape[-2:]), x_bgr.device)
    loc, conf, ldm = (t.float()[0] for t in net((x_bgr - mean).to(act)))
    return (decode_boxes(loc, priors) * box_scale,
            decode_landms(ldm, priors) * lm_scale, conf[:, 1])


def select_detections(boxes, lms, scores, confidence_threshold=0.9,
                      nms_threshold=0.4, top_k=5000, keep_top_k=750):
    """The candidates above the threshold are downloaded (only they), the
    best ``top_k`` by score go through NMS and ``keep_top_k`` stay: (dets
    [N,5] x1 y1 x2 y2 score, landmarks [N,10]) as numpy, in NMS order."""
    keep = torch.nonzero(scores > confidence_threshold).flatten()
    dets = torch.cat([boxes[keep], scores[keep, None]], dim=1).cpu().numpy()
    lms = lms[keep].cpu().numpy()
    order = dets[:, 4].argsort()[::-1][:top_k]
    dets, lms = dets[order], lms[order]
    kept = py_cpu_nms(dets, nms_threshold)
    return dets[kept][:keep_top_k], lms[kept][:keep_top_k]
