"""Options of the port's face-swap CLI: the flags of the JAX package's
``e4s_tpu/options/swap_options.py`` that the swap reads, plus ``--device``.

Left out, so that passing one is an error rather than a silent no-op:
``--train_G``, ``--fsencoder_type``, ``--outer_dilation``,
``--erode_radius``, ``--learn_in_w`` and ``--output_size``, which nothing
in either package's swap reads (the stitch's dilation is fixed at 5), and
``--channels_last``, a TPU layout switch (the port has one layout).
``--bf16`` runs Net3 in bfloat16 (the masked convs in the kernel's bf16
form), as the JAX package's flag does.
"""

from argparse import ArgumentParser


def _bool(x) -> bool:
    return str(x).lower() != 'false'


class SwapFacePipelineOptions:
    def __init__(self):
        self.parser = ArgumentParser()
        self.initialize()

    def initialize(self):
        p = self.parser
        p.add_argument('--num_seg_cls', type=int, default=12)
        p.add_argument('--lap_bld', action='store_true',
                       help='Whether to use Laplacian multi-band blending')
        p.add_argument('--bf16', action='store_true',
                       help='bfloat16 Net3 (f32 demodulation, accumulation, parse '
                            'and stitch)')
        p.add_argument('--device', type=str, default='cuda',
                       help='torch device to run on, e.g. cuda, cuda:1, cpu')
        # ================= Model =====================
        p.add_argument('--out_size', type=int, default=1024)
        p.add_argument('--remaining_layer_idx', type=int, default=13)
        # ================== Pre-trained Models ==================
        p.add_argument('--start_from_latent_avg', default=True, type=_bool)
        p.add_argument('--n_styles', default=18, type=int)
        p.add_argument('--checkpoint_path',
                       default='./pretrained_ckpts/e4s/iteration_300000.pt', type=str)
        p.add_argument('--faceParser_name', default='default', type=str,
                       help='face parser name, [ default | segnext ]')
        p.add_argument('--faceParsing_ckpt',
                       default='./pretrained_ckpts/face_parsing/79999_iter.pth', type=str)
        p.add_argument('--segnext_config', default='', type=str)
        # ================== input & output ==================
        p.add_argument('--source', type=str, default="example/input/faceswap/source.jpg")
        p.add_argument('--target', type=str, default="example/input/faceswap/target.jpg")
        p.add_argument('--target_mask', type=str, default="")
        # crop and align source and target (dlib) before swapping
        p.add_argument('--need_crop', action='store_true')
        p.add_argument('--only_target_crop', action='store_true')
        # precomputed 68-point landmarks (.npz, arrays in file order: source,
        # target; only the target's with --only_target_crop): no dlib needed
        p.add_argument('--landmarks_npz', type=str, default="")
        p.add_argument('--verbose', default=False, type=lambda x: str(x).lower() == 'true')
        p.add_argument('--output_dir', type=str, default="example/output/faceswap")

    def parse(self, args=None):
        return self.parser.parse_args(args)
