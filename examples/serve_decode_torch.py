"""Serve a small model with batched requests on the PyTorch port: prefill,
then greedy decode.  The twin of examples/serve_decode.py.

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch zamba2-7b] \
        [--batch 4] [--device cuda|cpu]

Runs the reduced same-family (SMOKE) config through
``repro_torch.launch.serve.main`` with the reference's prompt (32 tokens)
and generation (16 tokens), on the CUDA card unless given ``--device cpu``.
``main(argv)`` returns the server's generated tokens, (batch, 16) int32.
"""
import argparse

from repro_torch.launch import serve


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return serve.main(["--arch", args.arch, "--smoke", "--batch",
                       str(args.batch), "--prompt-len", "32", "--gen", "16",
                       "--device", args.device])


if __name__ == "__main__":
    main()
