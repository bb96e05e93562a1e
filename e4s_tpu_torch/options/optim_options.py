"""Options of the port's inversion CLI: the flags of the JAX package's
``e4s_tpu/options/optim_options.py`` that the inversion reads, plus
``--device``.

Left out, so that passing one is an error rather than a silent no-op:
``--exp_dir``, ``--load_ema``, ``--fsencoder_type``, ``--train_G``,
``--test_batch_size``, ``--test_workers``, ``--output_size``,
``--learn_in_w``, ``--num_layers`` and ``--verbose``, which nothing in
either package's inversion reads.
"""

from argparse import ArgumentParser


def _bool(x) -> bool:
    return str(x).lower() != 'false'


class OptimOptions:
    def __init__(self):
        self.parser = ArgumentParser()
        self.initialize()

    def initialize(self):
        p = self.parser
        p.add_argument('--num_seg_cls', type=int, default=12)
        p.add_argument('--remaining_layer_idx', type=int, default=13)
        p.add_argument('--device', type=str, default='cuda',
                       help='torch device to run on, e.g. cuda, cuda:1, cpu')
        # ================= Model =====================
        p.add_argument('--out_size', type=int, default=1024)
        p.add_argument('--n_styles', default=18, type=int)
        p.add_argument('--checkpoint_path',
                       default="./pretrained_ckpts/e4s/iteration_300000.pt", type=str)
        p.add_argument('--start_from_latent_avg', action='store_true', default=True)
        # ================= Dataset =====================
        p.add_argument('--dataset_root', default='./data/CelebAMask-HQ', type=str)
        p.add_argument('--ds_frac', default=1.0, type=float)
        # ================= Optimization =========================
        p.add_argument('--lr', default=1e-2, type=float)
        p.add_argument('--opt_name', type=str, default='adam',
                       help='sgd | adam | sgdm | adamax')
        p.add_argument('--W_steps', type=int, default=200)
        # refine the generator's per-layer noise maps with the style vectors
        p.add_argument('--optimize_noise', action='store_true')
        p.add_argument('--bf16', action='store_true',
                       help='mixed-precision inversion: bf16 Net3 and criteria, '
                            'f32 style vectors and optimizer moments')
        p.add_argument('--save_intermediate', action='store_true')
        p.add_argument('--save_interval', type=int, default=50)
        p.add_argument('--output_dir', type=str, default='./work_dir/optim')
        # ================= Loss Functions =====================
        p.add_argument('--lpips_lambda', default=0.8, type=float)
        p.add_argument('--id_lambda', default=0.1, type=float)
        p.add_argument('--id_loss_multiscale', default=True, type=_bool)
        p.add_argument('--face_parsing_lambda', default=0.1, type=float)
        p.add_argument('--l2_lambda', default=1.0, type=float)
        p.add_argument('--ir_se50_path',
                       default='./pretrained_ckpts/auxiliray/model_ir_se50.pth', type=str)
        p.add_argument('--face_parsing_model_path',
                       default='./pretrained_ckpts/auxiliray/model.pth', type=str)

    def parse(self, args=None):
        return self.parser.parse_args(args)
