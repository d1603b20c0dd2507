"""Evaluation metrics of the port (see protnote_tpu/evaln/)."""
