"""Host decode, datasets, the batch pipeline and batch preprocessing."""
