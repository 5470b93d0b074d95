#!/usr/bin/env python
"""Command line of the PyTorch/CUDA port — the twin of ``train_tpu.py``.

Takes the flags the port has so far, with ``train_tpu.py``'s names and
defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).  Prints one JSON line per epoch.

MATCHA at budget 0.5 on the paper's 16-node ER graph (zoo id 4), ResNet-20,
gossip mixed by the perm kernel::

    python train_torch.py --model resnet20 --dataset synthetic_image \\
        --graphid 4 --numworkers 16 --budget 0.5 --bs 32 --epoch 10 \\
        --backend perm --wire-dtype f32

``--backend fused`` mixes each step with one dense product ``W_t @ x`` and
runs the comm-split timer's chains through the fused W-stack kernel;
``--backend dense`` is the dense product alone.
"""

from __future__ import annotations

import argparse
import json

from matcha_tpu_torch.train import TrainConfig, train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="resnet20",
                   help="resnet<depth>, res or mlp")
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | synthetic_image")
    p.add_argument("--numworkers", type=int, default=8)
    p.add_argument("--graphid", type=int, default=0,
                   help="zoo graph id (0-5); -1 uses --topology")
    p.add_argument("--topology", default="ring",
                   help="generator topology when --graphid is -1")
    p.add_argument("--budget", type=float, default=0.5)
    p.add_argument("--matcha", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--bs", type=int, default=32, help="per-worker batch size")
    p.add_argument("--lr", type=float, default=0.8)
    p.add_argument("--epoch", type=int, default=200, dest="epochs")
    p.add_argument("--backend", default="perm",
                   choices=["perm", "gather", "dense", "fused"],
                   help="gossip backend (perm|gather|dense|fused)")
    p.add_argument("--wire-dtype", default="f32", choices=["f32", "bf16"],
                   dest="wire_dtype")
    p.add_argument("--randomSeed", "--seed", type=int, default=9001,
                   dest="seed")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    cfg = TrainConfig(
        model=args.model, dataset=args.dataset, num_workers=args.numworkers,
        graphid=None if args.graphid < 0 else args.graphid,
        topology=args.topology, matcha=args.matcha, budget=args.budget,
        batch_size=args.bs, lr=args.lr, epochs=args.epochs,
        gossip_backend=args.backend, wire_dtype=args.wire_dtype,
        seed=args.seed)
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_args(argv)
    result = train(cfg, device=device)
    for h in result.history:
        print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                          for k, v in h.items()}))


if __name__ == "__main__":
    main()
