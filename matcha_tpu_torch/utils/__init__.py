"""Small utilities of the port: the device rule and the metrics."""

from .device import resolve_device, synchronize
from .metrics import cross_entropy_loss, top_k_accuracy

__all__ = ["cross_entropy_loss", "resolve_device", "synchronize",
           "top_k_accuracy"]
