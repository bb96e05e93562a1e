"""Layer "request": the whole of one call of ``FaceSwapper.swap_batch``
(uint8 arrays in, uint8 arrays out)."""
SPAN = "request"
TARGET = "e4s_tpu_torch.pipelines.face_swap:FaceSwapper.swap_batch"
