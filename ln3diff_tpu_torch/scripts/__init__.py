"""The port's command-line entries, run as ``python -m
ln3diff_tpu_torch.scripts.<name>`` (the JAX package's ``scripts/``):
``convert_checkpoint``, ``vit_triplane_diffusion_sample`` (and its
``_objaverse`` alias) and ``legacy_pkl_to_npz``."""
