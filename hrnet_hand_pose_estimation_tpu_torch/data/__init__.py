"""Host data for the port's training: the hand legend, synthetic samples,
the batching loader and the device prefetch."""
