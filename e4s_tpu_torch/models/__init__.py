"""Networks of the port; each module mirrors its e4s_tpu/models counterpart
and keeps the reference checkpoints' state_dict key names."""
