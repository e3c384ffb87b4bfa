"""The card the launch plans are sized for, an H100 SXM: its streaming
multiprocessors and the largest thread-block cluster it launches (above 8
blocks a non-portable size, which the kernels opt into)."""

SMS = 132
MAX_CLUSTER = 16
