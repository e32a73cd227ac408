"""Console entry points of the port (``pyproject.toml``
``[project.scripts]``): ``ln3diff-torch-sample``, ``ln3diff-torch-convert``
and ``ln3diff-torch-eg3d-warmup``, the counterparts of the JAX package's
``ln3diff-sample`` and ``ln3diff-convert``.  Each runs the entry's
``main`` with the process's arguments."""

from __future__ import annotations


def sample():
    from .scripts.vit_triplane_diffusion_sample import main
    main()


def convert_checkpoint():
    from .scripts.convert_checkpoint import main
    main()


def eg3d_warmup():
    from .training.eg3d_warmup import main
    main()
