"""Host data for the port's training and evaluation: the dataset readers
and their image helpers, the hand legend, synthetic samples, the batching
loader and the device prefetch."""
