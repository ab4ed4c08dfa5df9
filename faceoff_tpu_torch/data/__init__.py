"""Training data: the dataset on disk and its host geometry and
perturbations, the loaders, synthetic data, the resident corpus and the
training input on the device."""
