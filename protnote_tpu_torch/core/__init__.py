"""Checkpoint reading of the port (see protnote_tpu/core/checkpoint.py)."""
