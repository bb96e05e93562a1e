"""The reference's models for a configuration, their weights drawn on the
device from the seed (``draw.Draw``) in a fixed order, in the reference
checkpoints' key layout."""

from __future__ import annotations

import torch

from benchmark.reference.draw import Draw
from benchmark.reference.models.bisenet import BiSeNet
from benchmark.reference.models.facevid2vid.driver import FaceVid2Vid
from benchmark.reference.models.facevid2vid.generator import OcclusionAwareSPADEGenerator
from benchmark.reference.models.facevid2vid.keypoint_detector import HEEstimator, KPDetector
from benchmark.reference.models.gpen.gpen_model import GPENFullGenerator
from benchmark.reference.models.gpen.parsenet import ParseNet
from benchmark.reference.models.gpen.retinaface import RetinaFace
from benchmark.reference.models.gpen.rrdbnet import RRDBNet
from benchmark.reference.models.layers import init_module_
from benchmark.reference.models.net3 import Net3
from benchmark.reference.pipelines.reenact_restore import DeviceReenactRestore, Enhancer


def _make(build, draw: Draw):
    with torch.device("meta"):
        model = build()
    model.to_empty(device=draw.device)
    init_module_(model, draw)
    return model.eval().requires_grad_(False)


def build_models(config: dict, seed: int, device) -> dict:
    """name -> model, in the order their weights are drawn: ``net3``,
    ``parser`` and, with a chain, ``kp_detector``, ``he_estimator``,
    ``generator`` (FaceVid2Vid), ``facegan``, ``srmodel``, ``parsenet``,
    ``retinaface`` (GPEN)."""
    draw = Draw(seed, device)
    n = config["net3"]
    models = {
        "net3": _make(lambda: Net3(
            num_seg_cls=n["num_seg_cls"], out_size=n["out_size"],
            remaining_layer_idx=n["remaining_layer_idx"],
            split_layer_idx=n["split_layer_idx"], n_styles=n["n_styles"],
            start_from_latent_avg=n["start_from_latent_avg"],
            encoder_size=n["encoder_size"], encoder_slim=n["encoder_slim"],
            ch_div=n["ch_div"]), draw),
        "parser": _make(lambda: BiSeNet(n_classes=config["parser"]["n_classes"]), draw),
    }
    chain = config.get("chain")
    if chain:
        fv, gp = chain["fv2v"], chain["gpen"]
        models["kp_detector"] = _make(lambda: KPDetector(**(fv["kp_kwargs"] or {})), draw)
        models["he_estimator"] = _make(HEEstimator, draw)
        models["generator"] = _make(
            lambda: OcclusionAwareSPADEGenerator(**(fv["gen_kwargs"] or {})), draw)
        models["facegan"] = _make(lambda: GPENFullGenerator(
            gp["in_size"], channel_multiplier=gp["channel_multiplier"],
            narrow=gp["narrow"]), draw)
        models["srmodel"] = _make(lambda: RRDBNet(scale=gp["sr_scale"],
                                                  num_block=gp["sr_num_block"]), draw)
        models["parsenet"] = _make(lambda: ParseNet(gp["in_size"], gp["in_size"]), draw)
        models["retinaface"] = _make(RetinaFace, draw)
    return models


def latent_avg(config: dict, device) -> torch.Tensor:
    """The latent average of a random-weight Net3: zeros, as the port's
    loader gives without a checkpoint."""
    return torch.zeros((config["net3"]["n_styles"], 512), device=device)


def build_chain(config: dict, models: dict):
    """The re-enact -> restore chain over ``models``, or None."""
    chain = config.get("chain")
    if not chain:
        return None
    fv = FaceVid2Vid(models["kp_detector"], models["he_estimator"],
                     models["generator"], size=chain["fv2v"]["size"])
    enh = Enhancer(models["facegan"], models["srmodel"], models["parsenet"],
                   models["retinaface"], in_size=chain["gpen"]["in_size"],
                   force_one_face=chain["gpen"]["force_one_face"])
    return DeviceReenactRestore(fv, enh)
