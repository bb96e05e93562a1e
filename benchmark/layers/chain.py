"""Layer "chain": the re-enact -> restore chain, one pair per call
(FaceVid2Vid, RealESRNet x4, RetinaFace, GPEN, ParseNet)."""
SPAN = "chain"
TARGET = "e4s_tpu_torch.pipelines.reenact_restore:DeviceReenactRestore.__call__"
