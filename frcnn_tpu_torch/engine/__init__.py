"""Serving engine of the PyTorch port."""
