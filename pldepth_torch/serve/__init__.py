"""Serving pipeline."""
