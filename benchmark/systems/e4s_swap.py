"""System ``e4s_swap``: the port's ``FaceSwapper`` (BiSeNet parse, fused
swap, feathered stitch, f32), with the re-enact -> restore chain in front
where the configuration has one, and its check against the plain reference.

A system module gives the harness:

- ``build(config, seed, device, phases)`` -> (the system, a checksum of its
  weights): the port built through its own loaders and builders for the
  configuration, then given the benchmark's weights (drawn on the device
  from the seed by ``reference/build.py``) with ``load_state_dict``;
- ``Watch(system)``: per call, whether what it produced is finite
  (``take()``), read after the clock stops;
- ``check(config, seed, samples, calls, device, checksum)`` -> (numbers,
  whether the reference's weights drawn again match the system's);
- ``readings(config, seed, samples, calls, device)``: the program's numbers
  and the control's, for ``benchmark/readings.py``;
- ``count_flops(config, device)``: the whole step's FLOPs per image.

The check: once the window has closed and the system is freed, the plain
reference (``reference/``) is built with the same weights, drawn again from
the seed, and run on the inputs of a sample of the window's calls (the same
JPEG files or uint8 arrays): it re-enacts and restores the source where the
configuration has the chain (pair by pair, as the system does) and swaps
each call's pairs as one batch. Each result of the system is compared with
the reference's, image by image, over the pixels that the reference's swap
changed (its "face": where its result differs from the target):

  face_gt2  share of face pixels, in %, where a channel differs by more than
            2 levels: what a change in precision or a wrong layer moves;
  face_mad  mean absolute difference over the face, in levels.

Each number is the worst over the sampled images.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.check import worst


def swap_opts(config: dict):
    """The swap CLI's options at the configuration's sizes, no checkpoint
    paths (the weights come from the benchmark). Refuses what the
    reference does not compute: a parser other than BiSeNet, a stitch
    other than the feathered one, a precision other than f32."""
    from e4s_tpu_torch.options.swap_options import SwapFacePipelineOptions

    if (config["parser"]["name"], config["stitch"], config["precision"]["dtype"]) != (
            "bisenet", "feather", "float32"):
        raise ValueError("the reference computes the BiSeNet parse, the feathered "
                         "stitch and f32 only")
    opts = SwapFacePipelineOptions().parse([])
    n = config["net3"]
    for key in ("num_seg_cls", "out_size", "remaining_layer_idx", "n_styles",
                "start_from_latent_avg", "encoder_size", "encoder_slim", "ch_div"):
        setattr(opts, key, n[key])
    opts.parser_size = config["parser"]["parser_size"]
    opts.checkpoint_path = ""
    opts.faceParsing_ckpt = ""
    return opts


def build_port(config: dict, device):
    """(swapper, {name: the port's module that takes that weight set})."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    reenactor = restorer = None
    chain = config.get("chain")
    if chain:
        from e4s_tpu_torch.models.facevid2vid.driver import build_reenactor
        from e4s_tpu_torch.models.gpen.face_enhancement import build_restorer

        fv, gp = chain["fv2v"], chain["gpen"]
        reenactor = build_reenactor(None, device=device, size=fv["size"],
                                    kp_kwargs=fv["kp_kwargs"], gen_kwargs=fv["gen_kwargs"])
        restorer = build_restorer(
            {k: gp[k] for k in ("in_size", "use_sr", "sr_scale", "channel_multiplier",
                                "narrow", "force_one_face")}, device=device)
        if len(restorer.srmodel.body) != gp["sr_num_block"]:
            raise ValueError(f"the port's RealESRNet has {len(restorer.srmodel.body)} "
                             f"blocks, the configuration {gp['sr_num_block']}")
    swapper = FaceSwapper(swap_opts(config), device=device, reenactor=reenactor,
                          restorer=restorer)
    targets = {"net3": swapper.net, "parser": swapper.parser.model}
    if chain:
        targets.update(kp_detector=reenactor.kp_detector,
                       he_estimator=reenactor.he_estimator,
                       generator=reenactor.generator, facegan=restorer.facegan,
                       srmodel=restorer.srmodel, parsenet=restorer.faceparser,
                       retinaface=restorer.facedetector)
    return swapper, targets


def weights_checksum(models: dict) -> float:
    """A sum over every weight: the same weights give the same number."""
    total = torch.zeros((), dtype=torch.float64)
    for m in models.values():
        for t in m.state_dict().values():
            if t.is_floating_point():
                total = total + t.double().sum().cpu()
    return float(total)


def build(config: dict, seed: int, device, phases=None):
    """The port with the benchmark's weights: (swapper, checksum of the
    weights). The reference's copies are freed before this returns.
    ``phases`` takes the seconds of each step."""
    from benchmark.reference.build import build_models

    phases = {} if phases is None else phases
    t = time.perf_counter()
    ref = build_models(config, seed, device)
    checksum = weights_checksum(ref)
    phases["weights drawn"] = time.perf_counter() - t
    t = time.perf_counter()
    swapper, targets = build_port(config, device)
    phases["port built by its loaders"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        for name, model in targets.items():
            model.load_state_dict(ref[name].state_dict(), strict=True)
    del ref
    phases["weights loaded"] = time.perf_counter() - t
    return swapper, checksum


class Watch:
    """Per synthesis call, whether its face is finite (a device flag, from
    a forward hook on the generator)."""

    def __init__(self, swapper):
        self.flags = []
        self.handle = swapper.net.G.register_forward_hook(
            lambda m, i, out: self.flags.append(torch.isfinite(out[0]).all()))

    def take(self) -> bool:
        ok = all(bool(f) for f in self.flags)
        self.flags.clear()
        return ok

    def remove(self):
        self.handle.remove()


class Reference:
    """The plain reference with the configuration's weights drawn from the
    seed; ``outputs(src_u8, tgt_u8)`` -> its uint8 results [n,3,S,S]."""

    def __init__(self, config: dict, seed: int, device):
        from benchmark.reference.build import build_chain, build_models, latent_avg

        self.config, self.device = config, device
        self.models = build_models(config, seed, device)
        self.chain = build_chain(config, self.models)
        self.latent_avg = latent_avg(config, device)

    def checksum(self) -> float:
        return weights_checksum(self.models)

    @torch.no_grad()
    def outputs(self, src_u8, tgt_u8) -> np.ndarray:
        from benchmark.reference.ops.resize import bilinear_resize
        from benchmark.reference.pipelines.swap_core import swap_e2e

        S = self.config["net3"]["out_size"]
        s = torch.from_numpy(np.ascontiguousarray(src_u8)).to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(tgt_u8)).to(self.device)
        if self.chain is not None:
            ds = []
            for i in range(s.shape[0]):
                d = self.chain(s[i:i + 1], t[i:i + 1])
                if d.shape[-1] != S:
                    d = torch.round(bilinear_resize(d.float(), (S, S))).clamp(
                        0, 255).to(torch.uint8)
                ds.append(d)
            s = torch.cat(ds)
        out, _ = swap_e2e(self.models["net3"], self.models["parser"], s, t,
                          self.latent_avg, parser_size=self.config["parser"]["parser_size"])
        return out.cpu().numpy()


def compare(port_u8: np.ndarray, ref_u8: np.ndarray, target_u8: np.ndarray) -> dict:
    """Numbers for one image, each [3,S,S] uint8."""
    p = port_u8.astype(np.int16)
    r = ref_u8.astype(np.int16)
    diff = np.abs(p - r).max(axis=0)
    face = (ref_u8 != target_u8).any(axis=0)
    nf = int(face.sum())
    return {
        "face_gt2": 100.0 * float((diff[face] > 2).sum()) / nf if nf else 0.0,
        "face_mad": float(np.abs(p - r)[:, face].mean()) if nf else 0.0,
    }


def _rows(ref: Reference, samples, calls) -> list:
    rows = []
    for i, got in samples:
        src, tgt = calls.inputs(i)
        rows += [compare(g, r, t) for g, r, t in zip(got, ref.outputs(src, tgt), tgt)]
    return rows


def check(config: dict, seed: int, samples, calls, device, checksum):
    """(the worst of each number over ``samples`` [(call index, the
    system's uint8 result [n,3,S,S])], whether the weights drawn again are
    the system's)."""
    ref = Reference(config, seed, device)
    return worst(_rows(ref, samples, calls)), ref.checksum() == checksum


def readings(config: dict, seed: int, samples, calls, device) -> dict:
    """The program's numbers over ``samples``, and the control's: the
    reference computed with TF32 on (the precision below the
    configuration's f32) against the reference in f32, on the same calls."""
    ref = Reference(config, seed, device)
    ins = {i: calls.inputs(i) for i, _ in samples}
    want = {i: ref.outputs(*ins[i]) for i in ins}
    row = {"program": worst([compare(g, r, t) for i, got in samples
                             for g, r, t in zip(got, want[i], ins[i][1])])}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = {i: ref.outputs(*ins[i]) for i in ins}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    row["control_tf32"] = worst([compare(c, r, t) for i in ins
                                 for c, r, t in zip(low[i], want[i], ins[i][1])])
    row["face_px_share"] = float(np.mean([(want[i] != ins[i][1]).any(axis=1).mean()
                                          for i in ins]))
    return row


def count_flops(config: dict, device="cpu", seed: int = 0) -> int:
    """The whole step's FLOPs per image: the convolutions and matrix
    products of one pass of the plain reference at the configuration's
    sizes, batch 1, counted once by ``torch.utils.flop_counter``. The region
    loop of the masked convs is counted as one modulated conv per layer
    (the work of the layer, not of the loop's twelve), and elementwise work
    (activations, resizes, warps, blurs not done as products) is left out.
    With the chain, the one face that ``force_one_face`` stands in is
    restored. The input pair is the first two faces of the traffic."""
    from PIL import Image
    from torch.utils.flop_counter import FlopCounterMode

    import benchmark.reference.models.stylegan2 as sg
    from benchmark.harness.manifest import BENCH_DIR
    from benchmark.reference.ops.modconv import modulated_conv2d

    def one_region(x, w_scaled, s, mask, **kw):
        return modulated_conv2d(x, w_scaled, s[:, 0], **kw)

    def load(name):
        size = config["net3"]["out_size"]
        img = Image.open(BENCH_DIR / "traffic" / "faces" / name).convert("RGB")
        return np.asarray(img.resize((size, size)), np.uint8).transpose(2, 0, 1)[None]

    ref = Reference(config, seed, device)
    src, tgt = load("swap_source.jpg"), load("swap_target.jpg")
    naive = sg.masked_modulated_conv2d_naive
    sg.masked_modulated_conv2d_naive = one_region
    try:
        with FlopCounterMode(display=False) as fc:
            ref.outputs(src, tgt)
    finally:
        sg.masked_modulated_conv2d_naive = naive
    return int(fc.get_total_flops())
