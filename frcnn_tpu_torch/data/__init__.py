"""Image preparation of the PyTorch port."""
