"""Options of the port's training CLI: the flags of the JAX package's
``e4s_tpu/options/train_options.py`` that its Coach or the port's reads,
plus ``--device``; ``--distributed`` takes the process group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) in place of the JAX mesh flags.

Left out, so that passing one is an error rather than a silent no-op: the
mesh flags ``--coordinator_address``, ``--num_processes``,
``--process_id`` and ``--n_devices``; the TPU layout switch
``--channels_last``; and ``--fsencoder_type``, ``--test_batch_size``,
``--workers``, ``--test_workers``, ``--style_code_lambda``,
``--structure_code_lambda``, ``--learn_in_w`` and ``--output_size``, which
neither package's training reads.
"""

from argparse import ArgumentParser


def _bool(x) -> bool:
    return str(x).lower() != 'false'


class TrainOptions:
    def __init__(self):
        self.parser = ArgumentParser()
        self.initialize()

    def initialize(self):
        p = self.parser
        p.add_argument('--exp_dir', type=str, default="running_exp")
        p.add_argument('--device', type=str, default='cuda',
                       help='torch device to run on, e.g. cuda, cpu; under '
                            'torchrun each process takes cuda:LOCAL_RANK')
        p.add_argument('--distributed', action='store_true',
                       help='data parallel over torchrun processes (NCCL on '
                            'the card, gloo on the CPU); also on when '
                            'WORLD_SIZE > 1')
        p.add_argument('--num_seg_cls', type=int, default=12)
        # ================= Model =====================
        p.add_argument('--out_size', type=int, default=1024)
        p.add_argument('--remaining_layer_idx', type=int, default=13,
                       help='mask-guided style injection, i.e., K in paper')
        # ================= Dataset =====================
        p.add_argument('--celeba_dataset_root', default='./data/CelebAMask-HQ', type=str)
        p.add_argument('--ffhq_dataset_root', default='./data/FFHQ', type=str)
        p.add_argument('--dataset_name', default='celeba', type=str,
                       help='celeba | ffhq | synthetic')
        p.add_argument('--flip_p', default=0.5, type=float)
        p.add_argument('--ds_frac', default=1.0, type=float)
        p.add_argument('--batch_size', default=2, type=int,
                       help='batch size of each process')
        # ================= Training =====================
        p.add_argument('--learning_rate', default=0.0001, type=float)
        p.add_argument('--optim_name', default='adam', type=str,
                       help='adam | ranger')
        p.add_argument('--train_G', default=True, type=_bool)
        p.add_argument('--train_D', default=True, type=_bool)
        p.add_argument('--d_reg_every', default=-1, type=int)
        p.add_argument('--d_every', default=15, type=int)
        p.add_argument('--max_steps', default=200000, type=int)
        p.add_argument('--image_interval', default=200 * 5 * 2, type=int)
        # samples of the mean-latent estimate when no StyleGAN2 bootstrap or
        # resumed checkpoint gives latent_avg
        p.add_argument('--latent_avg_samples', default=100000, type=int)
        p.add_argument('--board_interval', default=30 * 10 * 2, type=int)
        p.add_argument('--val_interval', default=5000 * 2 * 2, type=int)
        p.add_argument('--save_interval', default=10000 * 5 * 2, type=int)
        p.add_argument('--seed', default=0, type=int)
        p.add_argument('--bf16', action='store_true',
                       help='mixed-precision training: bf16 compute in the '
                            'G and D steps, f32 master weights, optimizer and '
                            'EMA (demodulation, accumulation and R1 in f32)')
        p.add_argument('--tensorboard', action='store_true',
                       help='also write TensorBoard scalars (JSONL metrics '
                            'are always written)')
        # ================= Loss Function =====================
        p.add_argument('--lpips_lambda', default=0.8, type=float)
        p.add_argument('--id_lambda', default=0.1, type=float)
        p.add_argument('--id_loss_multiscale', default=True, type=_bool)
        p.add_argument('--face_parsing_lambda', default=0.1, type=float)
        p.add_argument('--l2_lambda', default=1.0, type=float)
        p.add_argument('--w_norm_lambda', default=0, type=float)
        p.add_argument('--r1_lambda', default=10, type=float)
        p.add_argument('--g_adv_lambda', default=0.01, type=float)
        p.add_argument('--style_lambda', default=0, type=float)
        p.add_argument('--style_loss_norm', default=1, type=int)
        # ================== styleGAN2 ==================
        p.add_argument('--stylegan_weights',
                       default='./pretrained_ckpts/stylegan2-ffhq-config-f.pt', type=str)
        p.add_argument('--start_from_latent_avg', action='store_true', default=True)
        p.add_argument('--n_styles', default=18, type=int)
        # auxiliary models
        p.add_argument('--ir_se50_path',
                       default='./pretrained_ckpts/auxiliray/model_ir_se50.pth', type=str)
        p.add_argument('--face_parsing_model_path',
                       default='./pretrained_ckpts/auxiliray/model.pth', type=str)
        p.add_argument('--checkpoint_path', default=None, type=str)

    def parse(self, args=None):
        return self.parser.parse_args(args)
