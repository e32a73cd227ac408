"""G-Objaverse text→3D sampling entry under the reference's file name.

The reference splits sampling into ``vit_triplane_diffusion_sample.py``
(ShapeNet/FFHQ) and ``vit_triplane_diffusion_sample_objaverse.py``
(t23d/i23d, hard-coded prompts at :189-223, the
``assets/objv_eval_pose.pt`` orbit); here both are
:mod:`~ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample`, and this
module keeps the reference's entry-point name:

    python -m ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample_objaverse
"""

from __future__ import annotations

from .vit_triplane_diffusion_sample import main

if __name__ == '__main__':
    main()
