"""Tensor ops of the port; each module mirrors its e4s_tpu/ops counterpart."""
