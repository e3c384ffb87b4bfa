"""Command-line entry points of the PyTorch port (``trainval_net``,
``test_net``), with the flags of the JAX package's ``tools/``."""
