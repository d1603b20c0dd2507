"""Data layer of the port: copies of the JAX package's host-only modules
(``protnote_tpu/data/``: FASTA, vocabularies, BLOSUM augmentation, the
label-embedding cache, datasets and bucketed batching), so the port imports
nothing of ``protnote_tpu``."""
