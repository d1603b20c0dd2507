"""Eval-mode model pieces of the port (see protnote_tpu/models)."""
