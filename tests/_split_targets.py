"""Worker targets for tests/test_torch_split.py's failure cases.

``repro_torch.sharding.cells.run_blocks`` starts each worker with the
spawn method, which imports the target by its module and name; these
live in a module of their own so that a worker imports nothing but them
and torch.
"""
import os
import time


def raises(block, device):
    """Raise with the block in the message."""
    raise ValueError(f"worker refused block {block!r} on {device}")


def exits(block, device):
    """End the process at once with exit code ``block``, no result sent."""
    os._exit(int(block))


def sleeps(block, device):
    """Sleep ``block`` seconds, then answer."""
    time.sleep(float(block))
    return block


def echoes(block, device):
    """Answer with the block and the device it ran on."""
    return block, str(device)
