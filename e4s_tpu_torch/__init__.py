"""e4s_tpu_torch: the E4S face-swap system in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the ``e4s_tpu`` package module for module and keeps the reference
checkpoints' ``state_dict`` key names. It imports no JAX and nothing of
``e4s_tpu``. Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
