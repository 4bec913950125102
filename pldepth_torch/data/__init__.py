"""Host decode and batch preprocessing."""
