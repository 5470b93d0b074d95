"""matcha_tpu_torch — the PyTorch/CUDA port of ``matcha_tpu``.

Decentralized SGD over N virtual workers held as rows of ``[N, ...]``
tensors, mixed by MATCHA's matching-decomposed gossip, on one NVIDIA H100.
The JAX package ``matcha_tpu`` stays the reference; this package imports
nothing of it (nor JAX), and keeps its own copy of the host-side numpy
layers it needs.  Every TPU kernel on a ported path is a hand-written
Hopper kernel under ``csrc/``, built at first use; its plain PyTorch
version serves CPU tensors only.  ``ROADMAP.md`` lists what is ported.
"""

__version__ = "0.1.0"
