"""The port's command-line entries, run as ``python -m
ln3diff_tpu_torch.scripts.<name>`` (the JAX package's ``scripts/``): the
training entries (``vit_triplane_train``, ``_diffusion_train``,
``_sit_train``, ``_cvD_train``, ``_cldm_train``), ``convert_checkpoint``,
``vit_triplane_diffusion_sample`` (and its ``_objaverse`` alias),
``legacy_pkl_to_npz``, the data tools (``wds_create``, ``lmdb_create``,
``profile_dataloading``), ``evaluator``, ``demo_two_stage`` and
``gradio_app``."""
