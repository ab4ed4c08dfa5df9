"""Training data on the device: synthetic corpora, the resident corpus and
the training-input pipeline."""
