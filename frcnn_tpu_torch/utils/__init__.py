"""Utilities of the PyTorch port (weight conversion)."""
