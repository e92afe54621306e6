"""Product models on tensors (counterpart of :mod:`mctpu.models`)."""
