"""Losses of the inversion path; each module mirrors its e4s_tpu/criteria counterpart."""
