"""Eval step of the port (see protnote_tpu/train/step.py)."""
