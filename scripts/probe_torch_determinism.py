"""Where two runs of the PyTorch port's 1024^2 swap part on one GPU.

    python3 scripts/probe_torch_determinism.py [--runs 3] [--no-chain]

Builds ``e4s_tpu_torch``'s FaceSwapper at 1024^2 (K=13, 18 styles, seeded
random weights, TF32 off) behind the re-enact -> restore chain (FaceVid2Vid
vox-256, GPEN-512 with ``force_one_face``; ``--no-chain`` leaves it out)
and swaps the example pair ``--runs`` times. Forward hooks on every module
of the chain's nets, Net3 and the parser record a checksum of the bits of
each call's inputs and outputs, in call order. The first call whose inputs
equal run 0's but whose output does not names the module that is not
bit-reproducible; the first call whose inputs already differ follows an op
outside any module. This is done three times: as the port runs, with
``torch.backends.cudnn.deterministic``, and with
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose warnings
name the ops that have no deterministic implementation.
"""

from __future__ import annotations

import argparse
import os
import sys
import types
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from e4s_tpu_torch.models.facevid2vid.driver import build_reenactor  # noqa: E402
from e4s_tpu_torch.models.gpen.face_enhancement import build_restorer  # noqa: E402
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper  # noqa: E402

EXAMPLE = os.path.join("example", "input", "faceswap")
GPEN = {"in_size": 512, "use_sr": True, "sr_scale": 4, "channel_multiplier": 2,
        "narrow": 1, "force_one_face": True}


def _bits(t):
    """Two int64 sums over a tensor's bit patterns (plain and position
    weighted): equal tensors give equal sums."""
    t = t.detach().contiguous()
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = t.view(width[t.element_size()]).flatten().long()
    w = torch.arange(v.numel(), device=v.device) % 977 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _hook(models, calls):
    def record(name):
        def fn(module, args, out):
            ins, outs = _tensors(args), _tensors(out)
            calls.append((name, [_bits(t) for t in ins], [_bits(t) for t in outs]))
        return fn

    handles = []
    for prefix, model in models.items():
        for name, m in model.named_modules():
            handles.append(m.register_forward_hook(record(f"{prefix}.{name}".rstrip("."))))
    return handles


def _first_parting(ref, got):
    """(index, name, kind) of the first call of ``got`` that differs from
    ``ref``: kind 'output' (inputs equal) or 'input'; None when equal."""
    for i, ((n0, i0, o0), (n1, i1, o1)) in enumerate(zip(ref, got)):
        same_in = len(i0) == len(i1) and all(torch.equal(a, b) for a, b in zip(i0, i1))
        if not same_in:
            return i, n1, "input"
        if not (len(o0) == len(o1) and all(torch.equal(a, b) for a, b in zip(o0, o1))):
            return i, n1, "output"
    return None


def run_mode(swapper, models, runs, label):
    src, tgt = (os.path.join(EXAMPLE, n) for n in ("source.jpg", "target.jpg"))
    results, traces = [], []
    for _ in range(runs):
        calls = []
        handles = _hook(models, calls)
        out = np.asarray(swapper.swap(src, tgt))
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        traces.append([(n, [b.cpu() for b in i], [b.cpu() for b in o]) for n, i, o in calls])
        results.append(out)
    for r in range(1, runs):
        same = np.array_equal(results[0], results[r])
        mse = np.mean((results[0].astype(np.float64) - results[r]) ** 2)
        psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        part = _first_parting(traces[0], traces[r])
        where = ("no module call differs" if part is None else
                 f"first differing call #{part[0]} of {len(traces[r])}: {part[1]} "
                 f"({'its output, with equal inputs' if part[2] == 'output' else 'its inputs'})")
        print(f"[determinism] {label}: run {r} vs run 0: result equal {same}, "
              f"uint8 PSNR {psnr:.2f} dB; {where}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--no-chain", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=1024, remaining_layer_idx=13, n_styles=18,
        start_from_latent_avg=True, checkpoint_path=None, faceParsing_ckpt=None)
    kw = {} if args.no_chain else dict(
        reenactor=build_reenactor(None, device="cuda", seed=5),
        restorer=build_restorer(GPEN, device="cuda", seed=6))
    swapper = FaceSwapper(opts, device="cuda", seed=0, **kw)
    models = {"net": swapper.net, "parser": swapper.parser.model}
    if swapper.chain is not None:
        c = swapper.chain
        models.update(kp=c.fv2v.kp_detector, he=c.fv2v.he_estimator,
                      fv2v=c.fv2v.generator, sr=c.sr, det=c.det, gpen=c.gan,
                      parsenet=c.parser)
    print(f"[determinism] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}", flush=True)
    np.asarray(swapper.swap(os.path.join(EXAMPLE, "source.jpg"),
                            os.path.join(EXAMPLE, "target.jpg")))  # warm-up
    run_mode(swapper, models, args.runs, "as the port runs")
    torch.backends.cudnn.deterministic = True
    run_mode(swapper, models, args.runs, "cudnn.deterministic")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_mode(swapper, models, args.runs, "use_deterministic_algorithms")
    ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"[determinism] ops without a deterministic implementation: {ops}", flush=True)


if __name__ == "__main__":
    main()
