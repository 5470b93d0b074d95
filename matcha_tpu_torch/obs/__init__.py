"""Observability of the port: the run journal and the best-effort IO seam.
Port of the writer side of ``matcha_tpu.obs`` (``journal``, ``bestio``);
the report tools stay with the JAX package, which reads the port's
journals unchanged."""
