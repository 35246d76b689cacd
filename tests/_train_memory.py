"""XLA's memory analysis of the reference's jitted train step at the
trainer records' widths, on abstract shapes: nothing is allocated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_train_memory.py \
        [ARCH:LAYERS ...]

For each config (default: Qwen3-8B, Mixtral-8x22B, Mistral-Large-123B and
Llama-4-Scout-17B-16E, each cut to 1 layer) the reference's step as its
trainer jits it at ``--fl-bits 4``, ``jax.jit(steps.make_train_step(model,
adamw(...), fl_bits=4))``, is lowered and compiled on
``jax.ShapeDtypeStruct``s of the parameters, the AdamW state and a 4 x 128
token batch (with a vlm's image or an encdec's frame features), once
with the optimizer state donated (``donate_argnums=(1,)``) and once with
the parameters too (``(0, 1)``).  It prints the parameter
count and, from ``compiled.memory_analysis()``, argument + output + temp -
alias in GiB: what the step holds at its peak, before the process's own
overhead (about 1.2 GiB: Qwen3-8B's record peaked at 26.51 GiB of RSS
against 25.33).  These decide which trainer records this container's CPU
can write (``tests/_torch_reference_worker.py --write-train-reference``).
"""
from __future__ import annotations

import dataclasses
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
DEFAULT = ("qwen3-8b:1", "mixtral-8x22b:1", "mistral-large-123b:1",
           "llama4-scout-17b-a16e:1")


def step_gib(arch, layers, donate):
    """(parameter count, the step's argument + output + temp - alias in
    GiB) for ``arch`` cut to ``layers`` with ``donate_argnums=donate``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.launch import steps
    from repro.models.registry import build_model
    from repro.optim import adamw, linear_warmup_cosine

    model = build_model(dataclasses.replace(get_config(arch),
                                            num_layers=layers))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = adamw(linear_warmup_cosine(3e-4, 10, 12))
    state = jax.eval_shape(opt.init, params)
    tokens = jax.ShapeDtypeStruct((4, 128), jnp.int32)
    batch = {"tokens": tokens, "labels": tokens}
    # a vlm's and an encdec's modality inputs, as the trainer draws them
    frames = {"vlm": ("img_feats", model.cfg.num_image_tokens),
              "encdec": ("enc_feats", max(128 // 4, 8))}
    if model.cfg.family in frames:
        name, n = frames[model.cfg.family]
        batch[name] = jax.ShapeDtypeStruct((4, n, model.cfg.d_model),
                                           jnp.bfloat16)
    step = steps.make_train_step(model, opt, fl_bits=4)
    mem = jax.jit(step, donate_argnums=donate).lower(
        params, state, batch).compile().memory_analysis()
    total = (mem.argument_size_in_bytes + mem.output_size_in_bytes
             + mem.temp_size_in_bytes - mem.alias_size_in_bytes)
    count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        params))
    return count, total / 2 ** 30


def main(argv):
    sys.path.insert(0, TESTS)
    import _torch_reference_worker as worker

    worker.apply_shim()
    for spec in argv or DEFAULT:
        arch, layers = spec.split(":")
        count, state_only = step_gib(arch, int(layers), (1,))
        _, both = step_gib(arch, int(layers), (0, 1))
        print(f"{arch} at {layers} layer(s): {count / 1e9:.3f}B parameters; "
              f"state donated {state_only:.2f} GiB, parameters and state "
              f"donated {both:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
