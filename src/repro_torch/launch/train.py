"""Training launcher of the PyTorch port (counterpart of the JAX
package's ``launch/train.py``, with its flags), on the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --tiny --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

``--device cpu`` trains on the CPU instead (the default, ``cuda``,
raises without a card).  Selects the WSD schedule for minicpm-2b (its
paper's schedule), cosine elsewhere.  The reference's launcher has no
``--compress-grads`` flag (only its ``optim/compress.py`` docstring
names one), so neither has this; the int8 cross-pod reduction is
``optim.compress.compressed_psum``, and a sharded run is
``Trainer(..., mesh=launch.mesh.make_host_mesh(...))``.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preempt-flag", default=None)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the card, the default) or "cpu"')
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    schedule = "wsd" if args.arch == "minicpm-2b" else "cosine"
    tcfg = TrainConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        lr=args.lr, schedule=schedule, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        preempt_flag=args.preempt_flag)
    result = Trainer(cfg, tcfg, device=args.device).run()
    h = result["history"]
    if h:
        print(f"done: steps {h[0]['step']}..{h[-1]['step']} "
              f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
