"""Layer "request": the whole of one call of ``FaceSwapper.swap`` (image
files in, PIL image out), so that host time inside a request and outside
the other spans is told apart from the benchmark's own time between
calls."""
SPAN = "request"
TARGET = "e4s_tpu_torch.pipelines.face_swap:FaceSwapper.swap"
