"""Batched serving driver: prefill a prompt batch, then greedy-decode; the
port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; ``--num-layers`` cuts
the depth (a model too deep for one card runs at its published widths).
The weights are drawn
from ``--seed`` and the prompts are ``jax.random.randint(fold_in(key, 1),
(batch, prompt_len), 0, vocab_size)``, the reference's; so are the
modality inputs, bf16 normals: a vlm's image features under ``fold_in(key,
2)`` (B, num_image_tokens, d_model), an encdec's frame embeddings under
``fold_in(key, 3)`` (B, max(prompt_len, 8), d_model), encoded once before
the prefill.  Decoding goes through the families' own caches
(``layers.chunked_attention`` for attention), as the reference's does.
Every family of the reference's registry runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def modality_inputs(model, params, key, batch: int, prompt_len: int,
                    device) -> dict:
    """The reference's modality inputs of a serve run: a vlm's
    ``img_feats``, an encdec's ``enc_out`` (its ``enc_feats`` encoded
    once); none for the token families."""
    cfg = model.cfg
    if cfg.family not in ("vlm", "encdec"):
        return {}
    vlm = cfg.family == "vlm"
    frames = cfg.num_image_tokens if vlm else max(prompt_len, 8)
    shape = (batch, frames, cfg.d_model)
    feats = prng.normal(prng.fold_in(key, 2 if vlm else 3), math.prod(shape),
                        device=device, dtype=torch.bfloat16).reshape(shape)
    if vlm:
        return {"img_feats": feats}
    from repro_torch.models import encdec

    with torch.no_grad():
        return {"enc_out": encdec.encode(params, feats, cfg)}


def generate(model, params, prompts: torch.Tensor, gen: int,
             extras=None):
    """Prefill ``prompts`` (B, P) into fresh caches, then ``gen - 1``
    greedy decode steps; ``extras`` (:func:`modality_inputs`) go to the
    prefill and to every step.  Returns (tokens (B, gen) int32, prefill
    seconds, decode seconds)."""
    cfg = model.cfg
    extras = extras or {}
    device = prompts.device
    batch, prompt_len = prompts.shape
    caches = model.init_cache(batch, prompt_len + gen + 1, device=device)
    _sync(device)
    t0 = time.time()
    with torch.no_grad():
        out = model.module.forward(params, prompts, cfg, caches=caches,
                                   **extras)
    logits, caches = out[0], out[1]
    tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1).to(
        torch.int32)
    _sync(device)
    t_prefill = time.time() - t0

    serve_step = steps_lib.make_serve_step(model)
    generated = [tok]
    t0 = time.time()
    for _ in range(gen - 1):
        tok, caches = serve_step(params, caches, {"tokens": tok, **extras})
        generated.append(tok)
    _sync(device)
    t_decode = time.time() - t0
    return torch.cat(generated, dim=1), t_prefill, t_decode


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers (the widths "
                         "stay the published ones; a vlm's must stay a "
                         "multiple of its cross_attn_every); default: the "
                         "config's")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run(argv=None) -> dict:
    """:func:`main`'s run, returning what it drew and measured: the
    ``tokens`` (B, gen), the ``model``, its ``params``, the ``prompts``,
    the modality inputs ``extras``, and the ``prefill_s`` and ``decode_s``
    seconds."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = build_model(cfg)
    key = prng.prng_key(args.seed)
    params = model.init(key, device=device)
    prompts = prng.randint(prng.fold_in(key, 1),
                           (args.batch, args.prompt_len), 0, cfg.vocab_size,
                           device=device)

    extras = modality_inputs(model, params, key, args.batch,
                             args.prompt_len, device)
    gen, t_prefill, t_decode = generate(model, params, prompts, args.gen,
                                        extras)
    print(f"arch={cfg.name} prefill {args.prompt_len} tok in {t_prefill:.2f}s; "
          f"decoded {args.gen} tok in {t_decode:.2f}s "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample generation (ids):", gen[0, :16].tolist())
    assert gen.shape == (args.batch, args.gen)
    assert bool(torch.all((gen >= 0) & (gen < cfg.vocab_size)))
    return dict(tokens=gen, model=model, params=params, prompts=prompts,
                extras=extras, prefill_s=t_prefill, decode_s=t_decode)


def main(argv=None):
    return run(argv)["tokens"]


if __name__ == "__main__":
    main()
