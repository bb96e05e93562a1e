"""Layer "synthesis": ``Net3.gen_img`` (``models/stylegan2.py::Generator``,
the first K = 13 layers region-masked)."""
SPAN = "synthesis"
TARGET = "e4s_tpu_torch.models.net3:Net3.gen_img"
