"""Layer "texture encoder": ``Net3.get_style_vectors``
(``models/encoders.py::FSEncoderPSP`` and the masked region pooling)."""
SPAN = "encoder"
TARGET = "e4s_tpu_torch.models.net3:Net3.get_style_vectors"
