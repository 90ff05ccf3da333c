"""Experiment flows of the port: GAN augmentation, the latent sweep, its
reports and the CLI (``python -m hfrep_tpu_torch``)."""
