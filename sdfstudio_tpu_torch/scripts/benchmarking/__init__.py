"""Microbenchmarks of the primitives the port is built from (counterpart of
``sdfstudio_tpu/scripts/benchmarking/``)."""
