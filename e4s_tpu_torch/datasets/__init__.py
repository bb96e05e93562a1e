"""Datasets the edit and inversion paths read (e4s_tpu/datasets counterpart)."""
