"""Build the host libraries of ``frcnn_tpu_torch/native`` with ``g++``.

Each library is one ``native/<name>.cc``, compiled at first use into
``frcnn_tpu_torch/_build/`` (git-ignored) under a name that carries a hash
of the source and the command's flags, as ``ops/cuda/build.py`` names the
kernels' library: an edited source is rebuilt and a stale library is never
loaded.  The build reads only the sources in this directory.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

NATIVE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_library(name: str, flags=(), libs=()) -> str:
    """The path of ``lib<name>_<hash>.so`` built from ``native/<name>.cc``
    with ``flags`` (before the source) and ``libs`` (after it); built now
    unless it exists.  Raises ``OSError`` (no ``g++``) or
    ``subprocess.CalledProcessError`` (the compiler's output attached)."""
    source = os.path.join(NATIVE, name + ".cc")
    cmd = (*CXX_FLAGS, *flags)
    digest = hashlib.sha1(" ".join((*cmd, *libs)).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *cmd, source, "-o", tmp, *libs], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    return path
