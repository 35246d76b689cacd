"""Train an assigned architecture (reduced config) on the PyTorch port with
the paper's gradient-compression uplink in the loop.  The twin of
examples/train_llm.py.

    PYTHONPATH=src python examples/train_llm_torch.py [--arch mixtral-8x22b] \
        [--steps 30] [--fl-bits 8] [--device cuda|cpu]

Each optimizer step quantizes the gradient tree to ``--fl-bits`` through
DoReFa (kernel #5 on the card, one launch a leaf) before the update:
``repro_torch.launch.train.main`` on the SMOKE config at batch 8, sequence
128, on the CUDA card unless given ``--device cpu``.  ``main(argv)``
returns the trainer's losses, one a step.
"""
import argparse

from repro_torch.launch import train


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--fl-bits", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return train.main(["--arch", args.arch, "--smoke", "--steps",
                       str(args.steps), "--batch", "8", "--seq", "128",
                       "--fl-bits", str(args.fl_bits), "--device",
                       args.device])


if __name__ == "__main__":
    main()
