"""Utilities of the PyTorch port: weight conversion, timer, summaries, box drawing."""
