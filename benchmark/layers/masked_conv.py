"""Layer "masked conv": the ``masked_modulated_conv2d`` that
``models/stylegan2.py`` calls (the CUDA kernel ``csrc/patch_mod_conv3.cu``
through ``ops/patch_modconv.py``, with its demodulation and region maps)."""
SPAN = "masked_conv"
TARGET = "e4s_tpu_torch.models.stylegan2:masked_modulated_conv2d"
