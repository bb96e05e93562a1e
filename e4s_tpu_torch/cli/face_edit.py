"""Texture-editing command line of the port (counterpart of
``scripts/face_edit.py``): moves the texture of ``--regions`` of the source
face towards the reference's by ``--alpha`` and writes ``edit_res.png``
under ``--output_dir``:

    python -m e4s_tpu_torch.cli.face_edit --regions hair eyes \\
        [--source S.jpg --reference R.jpg] [--alpha 1.0] \\
        [--faceParser_name segnext] [--output_dir DIR] [--device cuda]

Runs on the GPU unless ``--device cpu`` is given. Checkpoints that are not
found are replaced by seeded random weights (with a message).
"""

from __future__ import annotations

import os

from e4s_tpu_torch.options.edit_options import EditOptions
from e4s_tpu_torch.pipelines.face_edit import Editor


def main(argv=None):
    return run(EditOptions().parse(argv))


def run(opts):
    """The edit ``main`` runs, on parsed options."""
    result = Editor(opts, device=opts.device).interpolation()
    os.makedirs(opts.output_dir, exist_ok=True)
    path = os.path.join(opts.output_dir, "edit_res.png")
    result.save(path)
    print(f"Saved edit result to {path}")
    return result


if __name__ == "__main__":
    main()
