"""Experiment flows of the port: the CLI (``python -m hfrep_tpu_torch``)."""
