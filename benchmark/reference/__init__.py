"""The plain PyTorch reference that decides ``correct``: a frozen copy of the
model code the benchmark's cells run (Net3 with the mask-guided StyleGAN2,
FSEncoderPSP, BiSeNet, the swap and the feathered stitch; FaceVid2Vid,
GPEN, RealESRNet, RetinaFace, ParseNet and the re-enact -> restore glue),
with the masked convs as the original 12-conv region loop and no kernel of
the program. It imports nothing of the program; ``build.py`` draws its
weights from the seed (``draw.py``)."""
