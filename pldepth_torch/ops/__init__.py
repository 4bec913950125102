"""Ops: resize, SAME conv helpers, the fused decoder tail and the fused MBConv kernel (K2)."""
