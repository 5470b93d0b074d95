"""Small utilities of the port: the device rule, the metrics and the
profiler's window and spans."""

from .device import resolve_device, synchronize
from .metrics import cross_entropy_loss, top_k_accuracy
from .profiling import annotate, device_span, trace

__all__ = ["annotate", "cross_entropy_loss", "device_span", "resolve_device",
           "synchronize", "top_k_accuracy", "trace"]
