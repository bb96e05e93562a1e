"""JAX variable trees (nested dicts of arrays) -> the port's state_dicts.

The inverse of the JAX package's checkpoint converters
(``e4s_tpu/utils/torch_convert.py``: ``convert_net3_state_dict``,
``convert_discriminator``, ``convert_bisenet``, ``convert_segnext``,
``convert_irse50``, ``convert_unet``, ``convert_alexnet_features``,
``convert_vgg16_features``, ``convert_lpips_lin``, and the re-enactment and
restoration nets' converters). The keys are the
reference checkpoints', so the result loads into the port's modules with
``load_state_dict`` and converts back to the same JAX tree. Leaves are read with ``np.asarray``; JAX is not needed.
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


def _conv_layer(p, out, q, downsample, blur_kernel=(1, 3, 3, 1)):
    """A JAX ``ConvLayer`` -> the reference's Sequential keys:
    [Blur ``kernel``] conv ``weight`` (+ ``bias``) [activation ``bias``]."""
    i = 0
    if downsample:
        out[f"{q}.0.kernel"] = make_kernel(blur_kernel)
        i = 1
    out[f"{q}.{i}.weight"] = _t(p["conv"]["weight"])
    if "bias" in p["conv"]:
        out[f"{q}.{i}.bias"] = _t(p["conv"]["bias"])
    if "activate" in p:
        out[f"{q}.{i + 1}.bias"] = _t(p["activate"]["bias"])


def discriminator_state_dict_from_jax(params):
    """The JAX ``Discriminator`` params -> the port's ``Discriminator``
    state_dict (the reference's ``d`` keys)."""
    out = {}
    _conv_layer(params["convs_0"], out, "convs.0", False)
    j = 1
    while f"convs_{j}" in params:
        b = params[f"convs_{j}"]
        _conv_layer(b["conv1"], out, f"convs.{j}.conv1", False)
        _conv_layer(b["conv2"], out, f"convs.{j}.conv2", True)
        _conv_layer(b["skip"], out, f"convs.{j}.skip", True)
        j += 1
    _conv_layer(params["final_conv"], out, "final_conv", False)
    for i in (0, 1):
        out[f"final_linear.{i}.weight"] = _t(params[f"final_linear_{i}"]["weight"])
        out[f"final_linear.{i}.bias"] = _t(params[f"final_linear_{i}"]["bias"])
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


def _bn(out, key, params, stats):
    """A frozen BatchNorm's entries: the affine weight and bias (identity
    when the JAX module has none), running stats and a zero
    ``num_batches_tracked``."""
    n = np.asarray(stats["running_mean"]).shape[0]
    out[f"{key}.weight"] = _t(params["weight"]) if "weight" in params else torch.ones(n)
    out[f"{key}.bias"] = _t(params["bias"]) if "bias" in params else torch.zeros(n)
    out[f"{key}.running_mean"] = _t(stats["running_mean"])
    out[f"{key}.running_var"] = _t(stats["running_var"])
    out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _ir_trunk(p, st):
    """The JAX IR-50 trunk's ``input_*`` and ``body_{i}`` (BatchNorm IR or
    IR-SE units) -> ``input_layer.*`` and ``body.{i}.*``."""
    out = {"input_layer.0.weight": _t(p["input_conv"]["weight"]),
           "input_layer.2.weight": _t(p["input_prelu"]["weight"])}
    _bn(out, "input_layer.1", p.get("input_bn", {}), st["input_bn"])
    i = 0
    while f"body_{i}" in p:
        b, bs, q = p[f"body_{i}"], st[f"body_{i}"], f"body.{i}"
        if "shortcut_conv" in b:
            out[f"{q}.shortcut_layer.0.weight"] = _t(b["shortcut_conv"]["weight"])
            _bn(out, f"{q}.shortcut_layer.1", b["shortcut_norm"], bs["shortcut_norm"])
        _bn(out, f"{q}.res_layer.0", b["res_norm1"], bs["res_norm1"])
        out[f"{q}.res_layer.1.weight"] = _t(b["res_conv1"]["weight"])
        out[f"{q}.res_layer.2.weight"] = _t(b["res_prelu"]["weight"])
        out[f"{q}.res_layer.3.weight"] = _t(b["res_conv2"]["weight"])
        _bn(out, f"{q}.res_layer.4", b["res_norm2"], bs["res_norm2"])
        if "res_se" in b:
            out[f"{q}.res_layer.5.fc1.weight"] = _t(b["res_se"]["fc1"]["weight"])
            out[f"{q}.res_layer.5.fc2.weight"] = _t(b["res_se"]["fc2"]["weight"])
        i += 1
    return out


def irse50_state_dict_from_jax(variables):
    """{"params", "batch_stats"} of the JAX ``IRSE50Backbone`` -> the
    ``model_ir_se50.pth`` state_dict that the port's ``IRSE50Backbone``
    loads; the inverse of ``convert_irse50``. The JAX embedding BatchNorm
    has no affine part: its weight and bias become 1 and 0."""
    p, st = variables["params"], variables["batch_stats"]
    out = _ir_trunk(p, st)
    _bn(out, "output_layer.0", p["output_bn"], st["output_bn"])
    out["output_layer.3.weight"] = _t(p["output_linear_weight"])
    out["output_layer.3.bias"] = _t(p["output_linear_bias"])
    _bn(out, "output_layer.4", p.get("output_bn1d", {}), st["output_bn1d"])
    return out


def _linear(out, key, params):
    out[f"{key}.weight"] = _t(params["weight"])
    out[f"{key}.bias"] = _t(params["bias"])


def psp_gradual_state_dict_from_jax(variables):
    """The JAX ``GradualStyleEncoder`` -> pSp's keys (``input_layer``,
    ``body``, ``styles.{j}.convs.{2i}`` / ``.linear``, ``latlayer1/2``)."""
    p, st = variables["params"], variables["batch_stats"]
    out = _ir_trunk(p["trunk"], st["trunk"])
    j = 0
    while f"styles_{j}" in p:
        blk = p[f"styles_{j}"]
        i = 0
        while f"convs_{i}" in blk:
            _linear(out, f"styles.{j}.convs.{2 * i}", blk[f"convs_{i}"])
            i += 1
        _linear(out, f"styles.{j}.linear", blk["linear"])
        j += 1
    for name in ("latlayer1", "latlayer2"):
        _linear(out, name, p[name])
    return out


def psp_w_state_dict_from_jax(variables):
    """The JAX ``BackboneEncoderUsingLastLayerIntoW`` -> pSp's keys."""
    p, st = variables["params"], variables["batch_stats"]
    out = _ir_trunk(p["trunk"], st["trunk"])
    _linear(out, "linear", p["linear"])
    return out


def psp_wplus_state_dict_from_jax(variables):
    """The JAX ``BackboneEncoderUsingLastLayerIntoWPlus`` or
    ``CustomBackboneEncoderUsingLastLayerIntoWPlus`` -> pSp's keys
    (``output_layer_2.{0,3}``, ``linear``; the custom head's
    ``structure_linear``)."""
    p, st = variables["params"], variables["batch_stats"]
    out = _ir_trunk(p["trunk"], st["trunk"])
    _bn(out, "output_layer_2.0", p["output_bn"], st["output_bn"])
    out["output_layer_2.3.weight"] = _t(p["output_linear_weight"])
    out["output_layer_2.3.bias"] = _t(p["output_linear_bias"])
    _linear(out, "linear", p["linear"])
    if "structure_linear" in p:
        _linear(out, "structure_linear", p["structure_linear"])
    return out


def unet_state_dict_from_jax(variables):
    """{"params", "batch_stats"} of the JAX ``ParsingUNet`` -> the parsing
    U-Net's ``model.pth`` state_dict; the inverse of ``convert_unet``."""
    p, st = variables["params"], variables["batch_stats"]
    out = {}

    def unet_conv2(pp, ss, key):
        for idx in (1, 2):
            out[f"{key}.conv{idx}.0.weight"] = _t(pp[f"conv{idx}"]["weight"])
            out[f"{key}.conv{idx}.0.bias"] = _t(pp[f"conv{idx}"]["bias"])
            _bn(out, f"{key}.conv{idx}.1", pp[f"bn{idx}"], ss[f"bn{idx}"])

    for name in ("conv1", "conv2", "conv3", "conv4", "center"):
        unet_conv2(p[name], st[name], name)
    for name in ("up_concat4", "up_concat3", "up_concat2", "up_concat1"):
        out[f"{name}.up.weight"] = _t(p[name]["up_weight"])
        out[f"{name}.up.bias"] = _t(p[name]["up_bias"])
        unet_conv2(p[name]["conv"], st[name]["conv"], f"{name}.conv")
    out["final.weight"] = _t(p["final"]["weight"])
    out["final.bias"] = _t(p["final"]["bias"])
    return out


# torchvision ``features`` positions of the convs of each trunk
ALEX_CONV_IDS = (0, 3, 6, 8, 10)
VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def features_state_dict_from_jax(params, net_type="alex"):
    """The JAX ``AlexNetFeatures`` / ``VGG16Features`` params (``conv{i}``)
    -> torchvision's ``features`` state_dict (``{pos}.weight``); the
    inverse of ``convert_alexnet_features`` / ``convert_vgg16_features``.
    A truncated trunk (``VGG16Activations``: conv0-conv9) gives its convs'."""
    ids = ALEX_CONV_IDS if net_type == "alex" else VGG16_CONV_IDS
    out = {}
    for i, pos in enumerate(ids):
        if f"conv{i}" not in params:
            break
        out[f"{pos}.weight"] = _t(params[f"conv{i}"]["weight"])
        out[f"{pos}.bias"] = _t(params[f"conv{i}"]["bias"])
    return out


def lpips_state_dict_from_jax(params, net_type="alex"):
    """The JAX ``LPIPS`` params -> the port's ``LPIPS`` state_dict: the
    trunk under ``net.`` and the heads ``lin_i`` as ``lin.{i}.1.weight``
    (the LPIPS release's layout, inverse of ``convert_lpips_lin``)."""
    out = {f"net.{k}": v
           for k, v in features_state_dict_from_jax(params["net"], net_type).items()}
    i = 0
    while f"lin_{i}" in params:
        out[f"lin.{i}.1.weight"] = _t(params[f"lin_{i}"])
        i += 1
    return out


# ---------------------------------------------------------------------------
# Re-enactment (FaceVid2Vid) and restoration (GPEN): the inverses of
# ``convert_kp_detector``, ``convert_he_estimator``, ``convert_fv_generator``,
# ``convert_gpen_full_generator``, ``convert_rrdbnet``, ``convert_parsenet``
# and ``convert_retinaface``
# ---------------------------------------------------------------------------


def _renamed_state_dict(variables, rename):
    """Every leaf of ``params`` and ``batch_stats`` under the key
    ``rename(module path) + leaf``; each BatchNorm gets a zero
    ``num_batches_tracked``."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            key = ".".join(rename(path[:-1]) + path[-1:])
            out[key] = _t(v)
            if path[-1] == "running_mean":
                out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return out


def _sub(rules):
    """A ``rename`` from (regex, replacement) rules applied to each part of
    the module path; a replacement may hold dots (several parts)."""
    def rename(q):
        out = []
        for part in q:
            for pat, rep in rules:
                part = re.sub(pat, rep, part)
            out += part.split(".")
        return tuple(out)
    return rename


def _spectral(w):
    """A folded weight W -> (weight_orig, weight_u, weight_v) with
    u^T W v = 1, so that eval-mode spectral norm gives W back."""
    w = np.asarray(w, np.float32)
    mat = w.reshape(w.shape[0], -1).astype(np.float64)
    i = int(np.argmax((mat ** 2).sum(1)))
    u = np.zeros(mat.shape[0])
    u[i] = 1.0
    v = mat[i] / (mat[i] ** 2).sum()
    return _t(w), _t(u), _t(v)


def kp_detector_state_dict_from_jax(variables, image_channel=3, scale_factor=0.25):
    """The JAX ``KPDetector`` -> the reference's ``kp_detector`` keys; the
    anti-alias filter ``down.weight`` (a constant) comes from the port."""
    from e4s_tpu_torch.models.facevid2vid.util import AntiAliasInterpolation2d

    out = _renamed_state_dict(variables, _sub([
        (r"^down_(\d+)$", r"down_blocks.down\1"), (r"^up_(\d+)$", r"up_blocks.up\1")]))
    if scale_factor != 1:
        out["down.weight"] = AntiAliasInterpolation2d(image_channel, scale_factor).weight
    return out


def he_estimator_state_dict_from_jax(variables):
    """The JAX ``HEEstimator`` -> the reference's ``he_estimator`` keys."""
    out = _renamed_state_dict(variables, _sub([(r"^block([1357])_(\d+)$", r"block\1.b\1_\2")]))
    return {re.sub(r"^(fc_\w+)_(weight|bias)$", r"\1.\2", k): v for k, v in out.items()}


def fv_generator_state_dict_from_jax(variables):
    """The JAX ``OcclusionAwareSPADEGenerator`` -> the reference's
    ``generator`` keys, its SPADE blocks' convs under spectral norm."""
    out = _renamed_state_dict(variables, _sub([
        (r"^encoder_down_(\d+)$", r"encoder.down_blocks.\1"),
        (r"^decoder_up_(\d+)$", r"decoder.up_blocks.\1"),
        (r"^decoder_(conv|norm)$", r"decoder.\1"),
        (r"^down_blocks_(\d+)$", r"down_blocks.\1"),
        (r"^resblocks_3d_(\d+)$", r"resblocks_3d.3dr\1"),
        (r"^mlp_shared_conv$", "mlp_shared.0")]))
    for k in [k for k in out if re.search(r"\.conv_[01s]\.weight$", k)]:
        q = k[:-len(".weight")]
        out[f"{q}.weight_orig"], out[f"{q}.weight_u"], out[f"{q}.weight_v"] = (
            _spectral(out.pop(k)))
    return out


def gpen_state_dict_from_jax(variables, blur_kernel=(1, 3, 3, 1)):
    """The JAX ``GPENFullGenerator`` params -> ``GPEN-BFR-512.pth``'s keys."""
    p = variables["params"]
    fir = make_kernel(blur_kernel) * 4.0
    out = {}
    i = 0
    while f"ecd{i}" in p:
        _conv_layer(p[f"ecd{i}"], out, f"ecd{i}.0", i > 0, blur_kernel)
        i += 1
    out["final_linear.0.weight"] = _t(p["final_linear"]["weight"])
    out["final_linear.0.bias"] = _t(p["final_linear"]["bias"])
    g = p["generator"]
    i = 1
    while f"style_{i}" in g:
        out[f"generator.style.{i}.weight"] = _t(g[f"style_{i}"]["weight"])
        out[f"generator.style.{i}.bias"] = _t(g[f"style_{i}"]["bias"])
        i += 1
    out["generator.input.input"] = _t(g["input"])

    def styled(name, q, up):
        _modconv(g[name]["conv"], out, f"{q}.conv")
        if up:
            out[f"{q}.conv.blur.kernel"] = fir.clone()
        out[f"{q}.noise.weight"] = _t(g[name]["noise_weight"])
        out[f"{q}.activate.bias"] = _t(g[name]["activate"]["bias"])

    def to_rgb(name, q, up):
        _modconv(g[name]["conv"], out, f"{q}.conv")
        out[f"{q}.bias"] = _t(g[name]["bias"])
        if up:
            out[f"{q}.upsample.kernel"] = fir.clone()

    styled("conv1", "generator.conv1", False)
    to_rgb("to_rgb1", "generator.to_rgb1", False)
    j = 0
    while f"convs_{j}" in g:
        styled(f"convs_{j}", f"generator.convs.{j}", j % 2 == 0)
        j += 1
    j = 0
    while f"to_rgbs_{j}" in g:
        to_rgb(f"to_rgbs_{j}", f"generator.to_rgbs.{j}", True)
        j += 1
    return out


def gpen_sr_state_dict_from_jax(variables, blur_kernel=(1, 3, 3, 1)):
    """The JAX ``GPENFullGeneratorSR`` params -> the reference's
    FullGenerator_SR keys (the same layout as GPEN-BFR's: ``ecd*``,
    ``final_linear``, ``generator.*``, with the decoder's extra scales)."""
    return gpen_state_dict_from_jax(variables, blur_kernel)


def rrdbnet_state_dict_from_jax(variables):
    """The JAX ``RRDBNet`` -> RealESRNet's keys (``params_ema`` of the
    release)."""
    return _renamed_state_dict(variables, _sub([(r"^body_(\d+)$", r"body.\1")]))


def parsenet_state_dict_from_jax(variables):
    """The JAX ``ParseNet`` -> ``ParseNet-latest.pth``'s keys."""
    return _renamed_state_dict(variables, _sub([
        (r"^(encoder|body|decoder)_(\d+)$", r"\1.\2"),
        (r"^shortcut$", "shortcut_func"), (r"^norm$", "norm.norm")]))


def retinaface_state_dict_from_jax(variables):
    """The JAX ``RetinaFace`` -> ``RetinaFace-R50.pth``'s keys."""
    return _renamed_state_dict(variables, _sub([
        (r"^(layer\d)_(\d+)$", r"\1.\2"), (r"^downsample_conv$", "downsample.0"),
        (r"^downsample_bn$", "downsample.1"), (r"^conv$", "0"), (r"^bn$", "1"),
        (r"^(ClassHead|BboxHead|LandmarkHead)_(\d)$", r"\1.\2.conv1x1")]))
