"""setup_s: from the start of the process to the end of the warm-up:
imports, CUDA context, models built, weights drawn and loaded, the input
pool made, and every shape of the cell warmed up (the kernels' nvcc build
in a checkout's first run)."""


def read(ctx, suffix):
    return ctx.setup_s
