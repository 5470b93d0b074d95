"""Hardware probes of the port: one question each, asked on the card, each
run as ``python -m matcha_tpu_torch.probes.<name>``.

``split_probe`` — does splitting each step's product over two column
halves, so one half's cast overlaps the other half's products, speed up a
step of the fused W-stack chain (K4, the port of
``benchmarks/split_probe.py``)?

``perm_bench`` — is this tree's perm kernel (K1/K2) faster than another
tree's at the same shapes (``ab``)?
"""
