"""Face-swap command line of the port (counterpart of
``scripts/face_swap.py``):

    python -m e4s_tpu_torch.cli.face_swap --source S.jpg --target T.jpg \\
        [--lap_bld] [--faceParser_name segnext] [--target_mask M.png] \\
        [--need_crop | --only_target_crop] [--landmarks_npz L.npz] \\
        [--verbose true] [--output_dir DIR] [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. Checkpoints that are not
found are replaced by seeded random weights (with a message). With the
FaceVid2Vid and GPEN checkpoints under ``./pretrained_ckpts/`` the source is
first driven by the target's pose and restored, on the device; without
them it is swapped as it is (with a message).
"""

from __future__ import annotations

import numpy as np

from e4s_tpu_torch.options.swap_options import SwapFacePipelineOptions
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
from e4s_tpu_torch.pipelines.reenact import try_build_reenactor_restorer
from e4s_tpu_torch.utils.label_maps import celebahq_mask_to_faceparser_mask_detailed


def main(argv=None):
    return run(SwapFacePipelineOptions().parse(argv))


def run(opts):
    """The swap ``main`` runs, on parsed options."""
    target_mask = None
    if opts.target_mask:
        from PIL import Image

        # a CelebAMask-HQ label image -> the detailed 12 classes
        target_mask = celebahq_mask_to_faceparser_mask_detailed(
            np.asarray(Image.open(opts.target_mask).convert("L")))
    landmarks = None
    if opts.landmarks_npz:
        with np.load(opts.landmarks_npz) as z:
            landmarks = [z[k] for k in z.files]
    reenactor = restorer = None
    try:
        reenactor, restorer = try_build_reenactor_restorer(opts, device=opts.device)
    except FileNotFoundError as e:
        print(f"[e4s_tpu_torch] re-enactment/restoration unavailable ({e}); "
              "falling back to direct source texture")
    swapper = FaceSwapper(opts, device=opts.device, reenactor=reenactor,
                          restorer=restorer)
    result = swapper.swap(
        opts.source, opts.target, save_dir=opts.output_dir,
        target_mask=target_mask, need_crop=opts.need_crop,
        only_target_crop=opts.only_target_crop, landmarks=landmarks,
        verbose=opts.verbose,
    )
    print(f"Saved swap result to {opts.output_dir}")
    return result


if __name__ == "__main__":
    main()
