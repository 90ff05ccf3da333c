"""Observability of the port: the metric log and the block timer.

The rest of the JAX package's ``obs`` (events, gauges, the wall-clock
ledger, reports) is not ported yet.
"""
