"""See the package docstring of sdfstudio_tpu_torch."""
