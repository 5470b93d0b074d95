"""Hardware probes of the port: one question each, asked on the card, each
run as ``python -m matcha_tpu_torch.probes.<name>``.

``split_probe`` — does splitting each step's product over two column
halves, so one half's cast overlaps the other half's products, speed up a
step of the fused W-stack chain (K4, the port of
``benchmarks/split_probe.py``)?
"""
