"""Face-parsing masks over an FFHQ tree (counterpart of
``scripts/estimate_FFHQ_mask.py``): every ``<root>/images_1024/<dir>/*.png``
is parsed in batches on the device and its label map written to
``<root>/BiSeNet_mask/<dir>/`` (``--seg12``: the detailed 12 classes, else
the parser's 19), and its colours to ``<root>/BiSeNet_mask_vis/<dir>/``
with ``--save_vis``:

    python -m e4s_tpu_torch.cli.estimate_ffhq_mask --FFHQ_root ./data/FFHQ \\
        [--seg12] [--save_vis] [--batch_size 8] [--faceParser_name segnext] \\
        [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. A parser checkpoint that
is not found is replaced by seeded random weights (with a message).
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from types import SimpleNamespace

import numpy as np


def options():
    p = ArgumentParser()
    p.add_argument('--faceParser_name', default='default', type=str,
                   help='face parser name, [ default | segnext ]')
    p.add_argument('--faceParsing_ckpt', type=str,
                   default="./pretrained_ckpts/face_parsing/79999_iter.pth")
    p.add_argument('--segnext_config', default='', type=str)
    p.add_argument('--FFHQ_root', type=str, default="./data/FFHQ")
    p.add_argument('--save_vis', action='store_true')
    p.add_argument('--seg12', action='store_true')
    p.add_argument('--batch_size', type=int, default=8,
                   help='images parsed per batch on the device')
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to run on, e.g. cuda, cuda:1, cpu')
    return p


def main(argv=None):
    return run(options().parse_args(argv))


def run(opts):
    """The mask estimation ``main`` runs, on parsed options."""
    import torch
    from PIL import Image

    from e4s_tpu_torch.models.bisenet import face_parsing_demo
    from e4s_tpu_torch.pipelines.model_io import load_face_parser, resolve_device
    from e4s_tpu_torch.utils.img_utils import vis_mask_in_color

    device = resolve_device(opts.device)
    parser = load_face_parser(SimpleNamespace(**vars(opts), out_size=1024),
                              opts.faceParsing_ckpt, device=device)
    mask_dir = os.path.join(opts.FFHQ_root, "BiSeNet_mask")
    vis_dir = os.path.join(opts.FFHQ_root, "BiSeNet_mask_vis")
    for d in sorted(os.listdir(os.path.join(opts.FFHQ_root, "images_1024"))):
        print(f"Estimating {d} directory")
        os.makedirs(os.path.join(mask_dir, d), exist_ok=True)
        if opts.save_vis:
            os.makedirs(os.path.join(vis_dir, d), exist_ok=True)
        imgs = sorted(glob.glob(os.path.join(opts.FFHQ_root, "images_1024", d, "*.png")))
        for i in range(0, len(imgs), opts.batch_size):
            chunk = imgs[i:i + opts.batch_size]
            batch = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in chunk])
            img01 = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2).float() / 255.0
            masks = face_parsing_demo(parser, img01, convert_to_seg12=opts.seg12)
            for p, m in zip(chunk, masks):
                name = os.path.basename(p)
                Image.fromarray(m).save(os.path.join(mask_dir, d, name))
                if opts.save_vis:
                    Image.fromarray(vis_mask_in_color(m)).save(os.path.join(vis_dir, d, name))


if __name__ == "__main__":
    main()
