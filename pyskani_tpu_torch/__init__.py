"""pyskani_tpu_torch — the skani method on PyTorch and CUDA.

A port of the JAX package ``pyskani_tpu`` (FracMinHash sketching,
marker screening, sparse anchor chaining, ANI / aligned-fraction
estimation) with the same ``Database`` / ``Sketch`` / ``Hit`` API.  Plain
tensor code is PyTorch; the banded chain DP is a hand-written CUDA kernel
(``csrc/chain_dp.cu``) built with ``nvcc`` at first use.  Entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""

from .database import Database, Sketch
from .hit import Hit

__version__ = "0.1.0"
__author__ = "pyskani-tpu developers"

# Version of the skani method this engine reimplements (the JAX
# package's value: it documents method compatibility).
SKANI_VERSION = "0.3.0-compat"

__build__ = {
    "backend": "torch/cuda",
    "dependencies": {"skani": SKANI_VERSION},
}

__all__ = ["Sketch", "Database", "Hit", "SKANI_VERSION"]
