"""Data: synthetic motion clips and batches, the FC2 corpora and loaders,
and the device caches of the training corpora."""
