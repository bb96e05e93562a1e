"""GPEN blind face restoration of the port (counterpart of
``e4s_tpu/models/gpen``): the BFR-512 generator, RealESRNet, RetinaFace and
ParseNet."""
