"""Model loading for the port's pipelines (counterpart of
``e4s_tpu/pipelines/model_io.py``): a reference checkpoint through
``load_state_dict``, or seeded random weights.

Models are built on the ``meta`` device, then take the checkpoint's tensors
or CPU storage filled from a ``torch.Generator`` (so a seed gives the same
weights on every device), and are then moved.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from e4s_tpu_torch.convert import segnext_variant_from_sd
from e4s_tpu_torch.models.bisenet import BiSeNet, FaceParser
from e4s_tpu_torch.models.layers import init_module_
from e4s_tpu_torch.models.net3 import Net3
from e4s_tpu_torch.models.segnext import SegNeXt, SegNeXtFaceParser


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card present
    raises: nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def materialise(build, state_dict=None, seed: int = 0, device="cpu"):
    """``build()`` on the meta device; its weights are then ``state_dict``'s
    tensors (taken over, not copied) or, when that is None, drawn from a CPU
    generator seeded with ``seed``. Moved to ``device``, in eval mode,
    without gradients."""
    with torch.device("meta"):
        model = build()
    if state_dict is None:
        model.to_empty(device="cpu")
        init_module_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, assign=True)
    for m in model.modules():
        if hasattr(m, "load_constants"):  # buffers no state_dict carries
            m.load_constants()
    return model.to(device).eval().requires_grad_(False)


def _strip_module(state_dict):
    """Keys without the ``module.`` prefix of a DataParallel save."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def build_net(opts) -> Net3:
    return Net3(
        num_seg_cls=opts.num_seg_cls,
        out_size=opts.out_size,
        remaining_layer_idx=opts.remaining_layer_idx,
        n_styles=opts.n_styles,
        start_from_latent_avg=opts.start_from_latent_avg,
        encoder_size=getattr(opts, "encoder_size", 256),
        encoder_slim=getattr(opts, "encoder_slim", False),
        ch_div=getattr(opts, "ch_div", 1),
    )


def cast_bf16(net, latent_avg):
    """The JAX package's ``--bf16`` cast: every floating parameter and
    buffer of ``net`` (in place) and ``latent_avg`` become bfloat16. The
    pipelines take their compute dtype from ``latent_avg``; demodulation
    and accumulation stay f32 inside the ops, and the face parser is not
    cast. Returns (net, latent_avg)."""
    return net.to(torch.bfloat16), latent_avg.to(torch.bfloat16)


def load_net3(opts, checkpoint_path: Optional[str] = None, device="cuda",
              seed: int = 0):
    """Returns (net, latent_avg [n_styles, 512]) on ``device``. A reference
    checkpoint (``{"state_dict", "latent_avg"}``) loads when the file exists;
    otherwise the weights are random from ``seed`` and latent_avg is 0.
    With ``opts.bf16`` both are cast to bfloat16 (``cast_bf16``)."""
    device = resolve_device(device)
    checkpoint_path = checkpoint_path or getattr(opts, "checkpoint_path", None)
    latent_avg = torch.zeros((opts.n_styles, 512))
    state_dict = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        state_dict = _strip_module(ckpt["state_dict"])
        if ckpt.get("latent_avg") is not None:
            latent_avg = torch.as_tensor(ckpt["latent_avg"]).float()
    elif checkpoint_path:
        print(f"[e4s_tpu_torch] checkpoint {checkpoint_path} not found; "
              f"random weights from seed {seed}")
    net = materialise(lambda: build_net(opts), state_dict, seed, device)
    latent_avg = latent_avg.to(device)
    if getattr(opts, "bf16", False):
        return cast_bf16(net, latent_avg)
    return net, latent_avg


def _load_pth(path):
    """A parser checkpoint's state_dict: the file's dict, or its
    ``state_dict`` entry (mmseg)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return _strip_module(sd["state_dict"] if "state_dict" in sd else sd)


def load_face_parser(opts, ckpt_path: Optional[str] = None, device="cuda",
                     seed: int = 0):
    """The face parser ``opts.faceParser_name`` names: ``default`` ->
    BiSeNet (face-parsing.PyTorch, ``79999_iter.pth``); ``segnext`` ->
    SegNeXt in the variant ``opts.segnext_variant``, else the one the
    ``opts.segnext_config`` file name names, else "small" (an mmseg
    ``.pth`` names its own). The checkpoint loads when it exists; otherwise
    the weights are random from ``seed``. Both parse at
    ``opts.parser_size`` (default 512)."""
    name = getattr(opts, "faceParser_name", "default")
    if name not in ("default", "segnext"):
        raise ValueError(f"unknown face parser {name!r}")
    device = resolve_device(device)
    parser_size = getattr(opts, "parser_size", 512)
    state_dict = None
    if ckpt_path and os.path.exists(ckpt_path):
        state_dict = _load_pth(ckpt_path)
    elif ckpt_path:
        print(f"[e4s_tpu_torch] parser checkpoint {ckpt_path} not found; "
              f"random weights from seed {seed}")
    if name == "default":
        model = materialise(lambda: BiSeNet(n_classes=19), state_dict, seed, device)
        return FaceParser(model, size=opts.out_size, parser_size=parser_size)

    variant = getattr(opts, "segnext_variant", None)
    if variant is None:
        cfg = getattr(opts, "segnext_config", "") or ""
        variant = next((v for v in ("tiny", "small", "base", "large") if v in cfg),
                       "small")
    if state_dict is not None:
        inferred = segnext_variant_from_sd(state_dict)
        if inferred != variant:
            print(f"[e4s_tpu_torch] segnext variant {variant!r} requested but "
                  f"the checkpoint is {inferred!r}; using {inferred!r}")
        variant = inferred
    model = materialise(lambda: SegNeXt(variant), state_dict, seed, device)
    return SegNeXtFaceParser(model, parser_size=parser_size)
