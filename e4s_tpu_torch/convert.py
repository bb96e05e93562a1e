"""JAX variable trees (nested dicts of arrays) -> the port's state_dicts.

The inverse of the JAX package's checkpoint converters
(``e4s_tpu/utils/torch_convert.py``: ``convert_net3_state_dict``,
``convert_bisenet``, ``convert_segnext``). The keys are the reference checkpoints', so the result
loads into the port's modules with ``load_state_dict`` and converts back to
the same JAX tree. Leaves are read with ``np.asarray``; JAX is not needed.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from e4s_tpu_torch.ops.upfirdn2d import make_kernel


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _fsencoder(p, out, pre):
    out[f"{pre}input_layer.0.weight"] = _t(p["input_conv"]["weight"])
    out[f"{pre}input_layer.2.weight"] = _t(p["input_prelu"]["weight"])
    i = 0
    while f"body_{i}" in p:
        b, q = p[f"body_{i}"], f"{pre}body.{i}"
        if "shortcut_conv" in b:
            out[f"{q}.shortcut_layer.0.weight"] = _t(b["shortcut_conv"]["weight"])
        out[f"{q}.res_layer.1.weight"] = _t(b["res_conv1"]["weight"])
        out[f"{q}.res_layer.2.weight"] = _t(b["res_prelu"]["weight"])
        out[f"{q}.res_layer.3.weight"] = _t(b["res_conv2"]["weight"])
        out[f"{q}.res_layer.5.fc1.weight"] = _t(b["res_se"]["fc1"]["weight"])
        out[f"{q}.res_layer.5.fc2.weight"] = _t(b["res_se"]["fc2"]["weight"])
        i += 1


def _modconv(p, out, q):
    out[f"{q}.weight"] = _t(p["weight"])[None]  # OIHW -> [1,O,I,k,k]
    out[f"{q}.modulation.weight"] = _t(p["modulation"]["weight"])
    out[f"{q}.modulation.bias"] = _t(p["modulation"]["bias"])


def _generator(g, noises, out, pre, blur_kernel=(1, 3, 3, 1)):
    fir = make_kernel(blur_kernel) * 4.0
    i = 1
    while f"style_{i}" in g:
        out[f"{pre}style.{i}.weight"] = _t(g[f"style_{i}"]["weight"])
        out[f"{pre}style.{i}.bias"] = _t(g[f"style_{i}"]["bias"])
        i += 1
    out[f"{pre}input.input"] = _t(g["input"])

    def styled(name, q, up):
        _modconv(g[name]["conv"], out, f"{q}.conv")
        if up:
            out[f"{q}.conv.blur.kernel"] = fir.clone()
        out[f"{q}.noise.weight"] = _t(g[name]["noise"]["weight"])
        out[f"{q}.activate.bias"] = _t(g[name]["activate"]["bias"])

    def to_rgb(name, q, up):
        _modconv(g[name]["conv"], out, f"{q}.conv")
        out[f"{q}.bias"] = _t(g[name]["bias"])
        if up:
            out[f"{q}.upsample.kernel"] = fir.clone()

    styled("conv1", f"{pre}conv1", False)
    to_rgb("to_rgb1", f"{pre}to_rgb1", False)
    j = 0
    while f"convs_{j}" in g:
        styled(f"convs_{j}", f"{pre}convs.{j}", j % 2 == 0)
        j += 1
    j = 0
    while f"to_rgbs_{j}" in g:
        to_rgb(f"to_rgbs_{j}", f"{pre}to_rgbs.{j}", True)
        j += 1
    for name, v in noises.items():
        out[f"{pre}noises.{name}"] = _t(v)


def net3_state_dict_from_jax(variables, num_seg_cls: int = 12):
    """{"params": ..., "noises": {"G": {"noise_i": ...}}} of the JAX
    ``Net3`` -> the port's ``Net3`` state_dict."""
    p = variables["params"]
    out = {}
    _fsencoder(p["encoder"], out, "encoder.")
    for i in range(num_seg_cls):
        m = p[f"MLPs_{i}"]
        for j, fc in ((0, "fc1"), (2, "fc2")):
            out[f"MLPs.{i}.mlp.{j}.weight"] = _t(m[fc]["weight"])
            out[f"MLPs.{i}.mlp.{j}.bias"] = _t(m[fc]["bias"])
    _generator(p["G"], variables.get("noises", {}).get("G", {}), out, "G.")
    return out


def generator_state_dict_from_jax(variables):
    """{"params": ..., "noises": ...} of the JAX ``Generator`` alone -> the
    port's ``Generator`` state_dict (the reference's ``g_ema`` keys)."""
    out = {}
    _generator(variables["params"], variables.get("noises", {}), out, "")
    return out


def _flatten(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def bisenet_state_dict_from_jax(variables):
    """{"params": ..., "batch_stats": ...} of the JAX ``BiSeNet`` -> the
    port's ``BiSeNet`` state_dict (with BatchNorm running stats and a zero
    ``num_batches_tracked``)."""
    out = {}
    for path, v in _flatten(variables["params"]):
        out[".".join(_bisenet_path(path[:-1]) + path[-1:])] = _t(v)
    for path, v in _flatten(variables["batch_stats"]):
        module = _bisenet_path(path[:-1])
        out[".".join(module + path[-1:])] = _t(v)
        if path[-1] == "running_mean":
            out[".".join(module + ("num_batches_tracked",))] = torch.zeros(
                (), dtype=torch.long
            )
    return out


def _bisenet_path(q):
    """JAX module path -> the reference's: ``layer1_0`` -> ``layer1.0``,
    ``downsample_conv`` / ``downsample_bn`` -> ``downsample.0`` / ``.1``."""
    out = []
    for part in q:
        if part.startswith("layer") and "_" in part:
            out += part.split("_")
        elif part == "downsample_conv":
            out += ["downsample", "0"]
        elif part == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(part)
    return tuple(out)


# JAX SegNeXt module names -> the mmseg checkpoint's
_SEGNEXT_NAMES = {
    "stem_conv1": "patch_embed1.proj.0", "stem_bn1": "patch_embed1.proj.1",
    "stem_conv2": "patch_embed1.proj.3", "stem_bn2": "patch_embed1.proj.4",
    "attn_proj_1": "attn.proj_1", "attn_proj_2": "attn.proj_2",
    "attn_spatial": "attn.spatial_gating_unit", "mlp_fc1": "mlp.fc1",
    "mlp_dwconv": "mlp.dwconv.dwconv", "mlp_fc2": "mlp.fc2",
    "squeeze_conv": "squeeze.conv", "squeeze_norm": "squeeze.gn",
    "ham_in": "ham_in.conv", "ham_out": "ham_out.conv",
    "ham_out_norm": "ham_out.gn", "align_conv": "align.conv",
    "align_norm": "align.gn",
}


def _segnext_key(path):
    """JAX path (modules..., leaf) -> mmseg key: ``block2_0`` ->
    ``block2.0``, ``patch_embed3_proj`` -> ``patch_embed3.proj``, the
    LayerNorm leaf ``norm4_weight`` -> ``norm4.weight``."""
    out = []
    for part in path:
        if part in _SEGNEXT_NAMES:
            out.append(_SEGNEXT_NAMES[part])
        else:
            m = re.fullmatch(r"(block\d|norm\d|patch_embed\d)_(\w+)", part)
            out.append(f"{m[1]}.{m[2]}" if m else part)
    return ".".join(out)


def segnext_state_dict_from_jax(variables):
    """{"params": ..., "batch_stats": ...} of the JAX ``SegNeXt`` -> the
    mmseg state_dict (BatchNorm with a zero ``num_batches_tracked``), the
    inverse of ``e4s_tpu/utils/torch_convert.py::convert_segnext``; loads
    into the port's ``SegNeXt``."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables[coll]):
            key = _segnext_key(path)
            out[key] = _t(v)
            if path[-1] == "running_mean":
                out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return out


def segnext_variant_from_sd(sd):
    """The ``SEGNEXT_VARIANTS`` entry whose stage widths and depths the
    mmseg state_dict has."""
    from e4s_tpu_torch.models.segnext import SEGNEXT_VARIANTS

    dims = tuple(int(sd[f"backbone.norm{s}.weight"].shape[0]) for s in range(1, 5))
    depths = tuple(
        1 + max(int(k.split(".")[2]) for k in sd
                if k.startswith(f"backbone.block{s}."))
        for s in range(1, 5)
    )
    for name, cfg in SEGNEXT_VARIANTS.items():
        if tuple(cfg["embed_dims"]) == dims and tuple(cfg["depths"]) == depths:
            return name
    raise ValueError(f"no SegNeXt variant has widths {dims} and depths {depths}")
