"""Console entry points of the port (``pyproject.toml``
``[project.scripts]``): ``ln3diff-torch-train-vae``,
``ln3diff-torch-train-diffusion``, ``ln3diff-torch-train-sit``,
``ln3diff-torch-sample``, ``ln3diff-torch-evaluator``,
``ln3diff-torch-gradio``, ``ln3diff-torch-convert`` and
``ln3diff-torch-eg3d-warmup``, the counterparts of the JAX package's
``ln3diff-train-vae``, ``-train-diffusion``, ``-train-sit``,
``ln3diff-sample``, ``ln3diff-evaluator``, ``ln3diff-gradio`` and
``ln3diff-convert``.  Each runs the entry's ``main`` with the process's
arguments."""

from __future__ import annotations


def train_vae():
    from .scripts.vit_triplane_train import main
    main()


def train_diffusion():
    from .scripts.vit_triplane_diffusion_train import main
    main()


def train_sit():
    from .scripts.vit_triplane_sit_train import main
    main()


def sample():
    from .scripts.vit_triplane_diffusion_sample import main
    main()


def evaluator():
    from .scripts.evaluator import main
    main()


def gradio_app():
    from .scripts.gradio_app import main
    main()


def convert_checkpoint():
    from .scripts.convert_checkpoint import main
    main()


def eg3d_warmup():
    from .training.eg3d_warmup import main
    main()
