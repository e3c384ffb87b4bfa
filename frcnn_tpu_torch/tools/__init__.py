"""Command-line entry points of the PyTorch port (``trainval_net``,
``test_net``, ``reval``, ``demo``), with the flags of the JAX package's
``tools/``."""
