"""The face-editing demo of the port (counterpart of the repo's ``demo/``):
``gradio_demo.DemoHelper`` runs headless on the GPU; ``launch`` needs
gradio."""
