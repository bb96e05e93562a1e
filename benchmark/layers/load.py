"""Layer "request": the host side of a request, the PIL decode and resize
of both images (``FaceSwapper._load``, called once per image)."""
SPAN = "request.load"
TARGET = "e4s_tpu_torch.pipelines.face_swap:FaceSwapper._load"
HOST_CLOCK = True
