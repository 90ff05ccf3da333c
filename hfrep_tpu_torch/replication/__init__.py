"""Autoencoder replication: the engine, performance statistics and
spanning tests (``hfrep_tpu/replication``)."""
