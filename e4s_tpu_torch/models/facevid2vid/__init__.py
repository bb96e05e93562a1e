"""FaceVid2Vid re-enactor (vox-256) of the port (counterpart of
``e4s_tpu/models/facevid2vid``)."""
