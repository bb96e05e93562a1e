"""Pipelines of the port (counterparts of e4s_tpu/pipelines)."""
