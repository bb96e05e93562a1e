"""Interactive shape and texture editing (counterpart of
``demo/gradio_demo.py``): ``DemoHelper`` holds Net3 and the face parser on
one device (the GPU unless the CPU is asked for), caches each image's
texture vectors and regenerates with fixed noise; ``paint_region`` and
``sketch_strokes`` turn the sketch tool's strokes into a relabelled mask.
All of it runs headless; ``launch`` builds the two-tab gradio UI and needs
gradio.

    python -m e4s_tpu_torch.demo.gradio_demo [--device cuda]

Two faults of the JAX copy are repaired here: a 2-D stroke array that is
not boolean repaints only its stroked pixels (numpy read its integers as
row indices), and a gradio >= 4 sketch value, a dict of ``background``,
``layers`` and ``composite`` without ``mask``, gives its layers' strokes
instead of failing.
"""

from __future__ import annotations

import numpy as np
import torch

from e4s_tpu_torch.demo.gradio_utils import (
    COMP,
    COMP2INDEX,
    colored_mask_to_label_map,
    label_map_to_colored_mask,
)


def _stroke_pixels(strokes) -> np.ndarray:
    """A stroke overlay -> [H,W] bool: an RGB(A) overlay marks the pixels
    whose RGB is not black; a 2-D array its non-zero pixels."""
    strokes = np.asarray(strokes)
    if strokes.ndim == 3:
        return np.sum(strokes[:, :, :3], axis=-1) != 0
    return strokes != 0


def sketch_strokes(value):
    """The stroked pixels [H,W] bool of a sketch value: gradio 3's
    ``{"image", "mask"}``, gradio >= 4's ``{"background", "layers",
    "composite"}`` (the union of the layers), or an overlay array. None
    when the value holds no stroke layer."""
    if isinstance(value, dict):
        if value.get("mask") is not None:
            return _stroke_pixels(value["mask"])
        layers = [_stroke_pixels(layer) for layer in value.get("layers") or []
                  if layer is not None]
        return np.any(layers, axis=0) if layers else None
    return None if value is None else _stroke_pixels(value)


def paint_region(base_colored_mask: np.ndarray, stroke_mask, region):
    """The stroked pixels of ``stroke_mask`` (an overlay, or [H,W]
    booleans) relabelled as ``region`` on a coloured mask. Returns
    (edited coloured mask, ok, message)."""
    if region is None:
        return (base_colored_mask, False,
                "Please choose the region you want to edit on, and try again.")
    if stroke_mask is None:
        return base_colored_mask, False, "Please sketch on the mask, and try again."
    label_map = colored_mask_to_label_map(base_colored_mask)
    label_map[_stroke_pixels(stroke_mask)] = COMP2INDEX[region]
    return label_map_to_colored_mask(label_map), True, "Edit %s region success!" % region


class DemoHelper:
    """The demo's callbacks. ``opts``: the fields of
    ``options/edit_options.py`` (its defaults when None: Net3 at 1024^2);
    checkpoints that are not found are replaced by seeded random
    weights."""

    def __init__(self, opts=None, device="cuda", seed: int = 0):
        from e4s_tpu_torch.options.edit_options import EditOptions
        from e4s_tpu_torch.pipelines.face_edit import sample_fixed_noise
        from e4s_tpu_torch.pipelines.model_io import (
            load_face_parser,
            load_net3,
            resolve_device,
        )

        # the edit CLI's defaults; the demo reads none of its regions
        self.opts = opts or EditOptions().parse(["--regions", "hair"])
        self.device = resolve_device(device)
        self.net, self.latent_avg = load_net3(self.opts, device=self.device, seed=seed)
        self.parser = load_face_parser(
            self.opts, getattr(self.opts, "faceParsing_ckpt", None),
            device=self.device, seed=seed)
        self.noise = [n.to(self.device) for n in sample_fixed_noise(self.opts.out_size)]

        self.src_img = None
        self.initial_label_map = None
        self.initial_colored_map = None
        self.ref_img = None
        self.ref_label_map = None
        self.src_texture_vectors = None
        self.ref_texture_vectors = None

    # -------------------- helpers --------------------

    def _img(self, image_rgb_uint8, scale11: bool):
        """[H,W,3] uint8 -> [1,3,H,W] on the device, in [0,1] or [-1,1]."""
        x = torch.from_numpy(np.ascontiguousarray(image_rgb_uint8)).to(self.device)
        x = x.permute(2, 0, 1)[None].float() / 255.0
        return x * 2 - 1 if scale11 else x

    def _onehot(self, label_map):
        from e4s_tpu_torch.utils.img_utils import label_map_to_onehot

        lab = torch.from_numpy(np.asarray(label_map, np.int64)).to(self.device)
        return label_map_to_onehot(lab[None, None], self.opts.num_seg_cls).to(
            self.latent_avg.dtype)

    @torch.no_grad()
    def estimate_mask(self, image_rgb_uint8: np.ndarray) -> np.ndarray:
        """The 12-class label map [ps,ps] uint8 of an RGB uint8 image."""
        from e4s_tpu_torch.models.bisenet import face_parsing_demo

        return face_parsing_demo(self.parser, self._img(image_rgb_uint8, False), True)[0]

    @torch.no_grad()
    def _texture_vectors(self, img_rgb_uint8, label_map) -> np.ndarray:
        """The per-region texture vectors [1,12,1280] (float32, host)."""
        img = self._img(img_rgb_uint8, True).to(self.latent_avg.dtype)
        sv, _ = self.net.get_style_vectors(img, self._onehot(label_map))
        return sv.float().cpu().numpy()

    @torch.no_grad()
    def _generate(self, label_map, texture_vectors) -> np.ndarray:
        """Regenerate from a label map and texture vectors with the fixed
        noise -> [S,S,3] uint8."""
        from e4s_tpu_torch.utils.img_utils import tensor2im

        tv = torch.from_numpy(np.asarray(texture_vectors, np.float32)).to(
            self.device, self.latent_avg.dtype)
        codes = self.net.cal_style_codes(tv, self.latent_avg)
        struc = torch.zeros((1, 512, 32, 32), dtype=tv.dtype, device=self.device)
        img, _, _ = self.net.gen_img(struc, codes, self._onehot(label_map),
                                     randomize_noise=False, noise=self.noise)
        return np.asarray(tensor2im(img[0].float().cpu().numpy()))

    # -------------------- UI callbacks (headless) --------------------

    def set_source(self, image_rgb_uint8):
        """Parse the source and cache its texture vectors."""
        self.src_img = image_rgb_uint8
        self.initial_label_map = self.estimate_mask(image_rgb_uint8)
        self.initial_colored_map = label_map_to_colored_mask(self.initial_label_map)
        self.src_texture_vectors = self._texture_vectors(
            image_rgb_uint8, self.initial_label_map)
        return self.initial_colored_map, "Load input image success!"

    def set_reference(self, image_rgb_uint8):
        """Parse the reference and cache its texture vectors."""
        self.ref_img = image_rgb_uint8
        self.ref_label_map = self.estimate_mask(image_rgb_uint8)
        self.ref_texture_vectors = self._texture_vectors(
            image_rgb_uint8, self.ref_label_map)
        return "Load reference image success!"

    def edit_mask(self, region, stroke_mask):
        """Strokes repaint the source's initial coloured mask (every confirm
        starts again from it, as the reference's does)."""
        edited, _, msg = paint_region(self.initial_colored_map, stroke_mask, region)
        return edited, msg

    def shape_edit(self, edited_colored_mask):
        """The edited mask with the source's texture vectors."""
        label_map = colored_mask_to_label_map(np.asarray(edited_colored_mask))
        img = self._generate(label_map, np.array(self.src_texture_vectors))
        return img, "Edit shape success!"

    def texture_edit(self, regions, alpha):
        """The initial mask with each chosen region's texture moved towards
        the reference's by ``alpha``."""
        if not regions:
            return self.src_img, "Please choose the region you want to mix, and try again."
        mixed = np.array(self.src_texture_vectors)
        ref = np.array(self.ref_texture_vectors)
        for region in regions:
            idx = COMP2INDEX[region]
            mixed[0, idx] = (1 - alpha) * mixed[0, idx] + alpha * ref[0, idx]
        img = self._generate(self.initial_label_map, mixed)
        return img, "Edit %s region(s) success!" % " ".join(regions)

    def generate(self, edited_colored_mask=None, regions=(), alpha=1.0):
        """An edited mask (default: the initial one) with the chosen
        regions' textures moved towards the reference's -> [S,S,3]
        uint8."""
        label_map = (colored_mask_to_label_map(np.asarray(edited_colored_mask))
                     if edited_colored_mask is not None else self.initial_label_map)
        mixed = np.array(self.src_texture_vectors)
        if self.ref_texture_vectors is not None and regions:
            ref = np.array(self.ref_texture_vectors)
            for region in regions:
                idx = COMP2INDEX[region]
                mixed[0, idx] = (1 - alpha) * mixed[0, idx] + alpha * ref[0, idx]
        return self._generate(label_map, mixed)


def launch(device="cuda"):
    """The two-tab gradio UI around a ``DemoHelper`` on ``device``."""
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed; DemoHelper "
                         "(e4s_tpu_torch.demo.gradio_demo) runs headless without it")

    helper = DemoHelper(device=device)

    def edited_image(mask):
        if isinstance(mask, dict):
            return mask.get("image", mask.get("composite"))
        return mask

    with gr.Blocks(title="E4S face editing") as ui:
        gr.Markdown("## E4S — mask-guided face editing\nUpload a source face, sketch "
                    "on its parsed mask to reshape regions, or blend texture from a "
                    "reference face.")
        with gr.Row():
            input_img = gr.Image(label="input image")
            try:
                input_mask = gr.Image(label="mask", source="upload", tool="sketch")
            except TypeError:  # gradio >= 4 has no sketch tool on gr.Image
                input_mask = gr.ImageEditor(label="mask")
        with gr.Row():
            with gr.Tab("Shape editing"):
                region_radio = gr.Radio(COMP, value="hair", label="Facial regions",
                                        info="Which region(s) are you interested in?")
                shape_log = gr.Textbox(label="Operations logging:",
                                       value="Ready to edit shape...", lines=2,
                                       interactive=False)
                with gr.Row():
                    edit_mask_btn = gr.Button("Confirm mask editing")
                    face_shape_edit_btn = gr.Button("Get edited face")
            with gr.Tab("Texture editing"):
                region_groups = gr.CheckboxGroup(
                    choices=COMP, label="Facial regions",
                    info="Which region(s) are you interested in?")
                with gr.Row():
                    reference_img = gr.Image(label="Reference image")
                    with gr.Column():
                        alpha = gr.Slider(0, 1, value=1.0, label="Editing extent",
                                          info="Choose between 0 and 1")
                        texture_log = gr.Textbox(label="Operations logging:",
                                                 value="Ready to edit texture...",
                                                 lines=2, interactive=False)
                        face_texture_edit_btn = gr.Button("Get edited face")
            output_img = gr.Image(label="result")

        input_img.change(helper.set_source, inputs=[input_img],
                         outputs=[input_mask, shape_log], queue=False)
        reference_img.change(helper.set_reference, inputs=[reference_img],
                             outputs=[texture_log], queue=False)
        edit_mask_btn.click(
            lambda region, mask: helper.edit_mask(region, sketch_strokes(mask)),
            inputs=[region_radio, input_mask], outputs=[input_mask, shape_log])
        face_shape_edit_btn.click(lambda mask: helper.shape_edit(edited_image(mask)),
                                  inputs=[input_mask], outputs=[output_img, shape_log])
        face_texture_edit_btn.click(helper.texture_edit, inputs=[region_groups, alpha],
                                    outputs=[output_img, texture_log])
    ui.launch()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    launch(ap.parse_args().device)
