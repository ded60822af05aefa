"""Command-line entry points (``python -m octvr_tpu.cli.<name>``)."""
