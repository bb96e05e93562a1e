"""Layer "fused swap": the ``swap_e2e`` closure of
``pipelines/swap_core.py::make_swap_e2e``, held as ``FaceSwapper._swap_e2e``
(parse, mask swap, encoder, texture swap, LocalMLPs, synthesis, stitch)."""
SPAN = "swap_e2e"
TARGET = "system:_swap_e2e"
