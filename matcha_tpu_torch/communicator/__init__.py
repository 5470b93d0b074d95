"""Communicators: the consensus transform of each training step.  Port of
the decentralized half of ``matcha_tpu.communicator``."""

from .base import Communicator
from .decen import make_decen

__all__ = ["Communicator", "make_decen"]
