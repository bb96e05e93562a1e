"""Face-swap entry point of the port (counterpart of
``e4s_tpu/pipelines/face_swap.py::FaceSwapper``): the fused path only.

Re-enactment / restoration, crop and alignment, the staged path with a
caller-supplied target mask, ``lap_bld`` and ``swap_batch`` are not ported
yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from e4s_tpu_torch.pipelines.model_io import (
    load_face_parser,
    load_net3,
    resolve_device,
)
from e4s_tpu_torch.pipelines.swap_core import make_swap_e2e


class FaceSwapper:
    """Holds the models on one device; call ``swap`` or ``swap_from_arrays``
    per pair. ``device`` defaults to the GPU and raises when there is none."""

    def __init__(self, opts, device="cuda", seed: int = 0):
        self.opts = opts
        self.device = resolve_device(device)
        self.net, self.latent_avg = load_net3(opts, device=self.device, seed=seed)
        self.parser = load_face_parser(
            opts, getattr(opts, "faceParsing_ckpt", None), device=self.device,
            seed=seed,
        )
        self._swap_e2e = make_swap_e2e(
            self.net, self.parser.model,
            parser_size=getattr(opts, "parser_size", 512),
        )

    def _load(self, path) -> np.ndarray:
        from PIL import Image

        S = self.opts.out_size
        img = Image.open(path).convert("RGB").resize((S, S))
        return np.transpose(np.asarray(img, np.float32) / 255.0, (2, 0, 1))[None]

    def swap_from_arrays(self, S01: np.ndarray, T01: np.ndarray):
        """Swap the face of S01 onto T01, both [1,3,S,S] float in [0,1].
        Two uint8 uploads, one fused pass on the device, one uint8 download.
        Returns the result as a PIL image."""
        from PIL import Image

        def to_dev(a):
            u8 = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
            return torch.from_numpy(u8).to(self.device)

        out_u8 = self._swap_e2e(to_dev(S01), to_dev(T01), self.latent_avg)[0]
        return Image.fromarray(out_u8[0].permute(1, 2, 0).cpu().numpy())

    def swap(self, source: str, target: str, save_dir: Optional[str] = None):
        """Swap the face in image file ``source`` onto ``target`` (both
        resized to out_size, no crop). Returns the PIL image; saves it as
        ``swap_<source>_to_<target>.png`` under ``save_dir`` if given."""
        result = self.swap_from_arrays(self._load(source), self._load(target))
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            name = "swap_%s_to_%s.png" % (
                os.path.basename(source).split(".")[0],
                os.path.basename(target).split(".")[0],
            )
            result.save(os.path.join(save_dir, name))
        return result
