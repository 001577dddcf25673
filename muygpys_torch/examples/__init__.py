"""Workflows composed from the port's public API (counterparts of
:mod:`muygpys_tpu.examples`)."""
