"""Re-enactment (FaceVid2Vid) and restoration (GPEN) for the swap CLI
(counterpart of ``e4s_tpu/pipelines/reenact.py``): both from the reference
checkpoints, or an error when the FaceVid2Vid or GPEN-512 file is missing
(the CLI then swaps the source as it is)."""

from __future__ import annotations

import os

FV2V_CKPT = "./pretrained_ckpts/facevid2vid/00000189-checkpoint.pth.tar"
GPEN_BASE = "./pretrained_ckpts/gpen/"
GPEN_PARAMS = {
    "base_dir": GPEN_BASE,
    "in_size": 512,
    "use_sr": True,
    "sr_scale": 4,
    "channel_multiplier": 2,
    "narrow": 1,
}


def try_build_reenactor_restorer(opts, device="cuda"):
    """(reenactor, restorer) built from the checkpoints; FileNotFoundError
    when one is missing (random weights would only corrupt the face)."""
    from e4s_tpu_torch.models.facevid2vid.driver import build_reenactor
    from e4s_tpu_torch.models.gpen.face_enhancement import build_restorer
    from e4s_tpu_torch.pipelines.model_io import resolve_device

    device = resolve_device(device)
    if not os.path.exists(FV2V_CKPT):
        raise FileNotFoundError(FV2V_CKPT)
    gpen_main = os.path.join(GPEN_BASE, "weights", "GPEN-BFR-512.pth")
    if not os.path.exists(gpen_main):
        raise FileNotFoundError(gpen_main)
    return (build_reenactor(FV2V_CKPT, device=device),
            build_restorer(GPEN_PARAMS, device=device))
