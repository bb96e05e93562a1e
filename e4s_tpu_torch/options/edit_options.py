"""Options of the port's texture-editing CLI: the flags of the JAX
package's ``e4s_tpu/options/edit_options.py`` that the edit reads, plus
``--device``.

Left out, so that passing one is an error rather than a silent no-op:
``--fsencoder_type``, ``--train_G``, ``--output_size`` and
``--learn_in_w``, which nothing in either package's edit reads.
"""

from argparse import ArgumentParser


class EditOptions:
    def __init__(self):
        self.parser = ArgumentParser()
        self.initialize()

    def initialize(self):
        p = self.parser
        p.add_argument('--num_seg_cls', type=int, default=12)
        p.add_argument('--regions', type=str, nargs='+', required=True,
                       help='The facial component to operate on')
        p.add_argument('--remaining_layer_idx', type=int, default=13)
        p.add_argument('--out_size', type=int, default=1024)
        p.add_argument('--n_styles', default=18, type=int)
        p.add_argument('--device', type=str, default='cuda',
                       help='torch device to run on, e.g. cuda, cuda:1, cpu')
        p.add_argument('--checkpoint_path',
                       default='./pretrained_ckpts/e4s/iteration_300000.pt', type=str)
        p.add_argument('--faceParser_name', default='default', type=str,
                       help='face parser name, [ default | segnext ]')
        p.add_argument('--faceParsing_ckpt',
                       default='./pretrained_ckpts/face_parsing/79999_iter.pth', type=str)
        p.add_argument('--segnext_config', default='', type=str)
        p.add_argument('--start_from_latent_avg', action='store_true', default=True)
        p.add_argument('--source', type=str, default="example/input/faceedit/source.jpg")
        p.add_argument('--reference', type=str, default="example/input/faceedit/reference.jpg")
        p.add_argument('--output_dir', default="./example/output/faceedit", type=str)
        p.add_argument('--alpha', type=float, default=1.0)

    def parse(self, args=None):
        return self.parser.parse_args(args)
