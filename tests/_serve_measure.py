"""Measure the port's serving runs against the reference's serving records.

    PYTHONPATH=src python tests/_serve_measure.py [NAME ...]
    PYTHONPATH=src python tests/_serve_measure.py --smoke

NAME is a record of tests/torch_reference/serve_<NAME>.json (default: all
of them, each in its own process, one after another; the parent prints each
one's peak RSS and seconds).  For every run of the record it serves the
port on the CPU at the run's widths and depth (``launch.serve.generate``
on the record's prompts and the run's modality inputs) and reads it
against the record with ``chip_smoke.serve_readings``: the served tokens
(the steps through which they equal the reference's, each row's first
near-tie) and the teacher-forced logits (worst gap in bf16 ulps of the
row's largest |logit|, argmax flips).  Beside each it reads wrong runs, the
same weights' teacher-forced logits from a model that is wrong in one
place (:func:`wrong_runs`).  ``chip_smoke.SERVE_LOGIT_ULPS`` was set from
this script's output, between the sound reading and every wrong one.
``--smoke`` reads the SMOKE configs against the worker's SMOKE records
(written into a temporary directory) and the two wrong runs that
tests/test_torch_serve_records.py rejects: its SMOKE_LOGIT_ULPS was set
from that output.

The initial weights and modality features are the reference's own draws
(jax.random on the CPU, leaf by leaf in chunks): the port's plain Threefry
draw computes the same bits (tests/test_torch_draws.py; on the card
``[serve:*]`` holds its kernel's draw at the recorded elements), but at
1e9 elements a leaf it takes hours on a CPU.  Each drawn leaf is checked
against the init record's elements where there is one.  The largest run,
Llama-3.2-Vision-90B cut to 5 layers, holds 25.5 GB of float32 weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
NAMES = ("mamba2_130m", "zamba2_7b", "mixtral_8x22b", "seamless_m4t_medium",
         "llama_3_2_vision_90b", "qwen2_0_5b", "qwen3_8b", "granite_34b",
         "llama4_scout_17b_a16e", "mistral_large_123b")


def _slice(tree, index):
    """Every leaf of ``tree`` indexed by ``index`` (a view)."""
    if isinstance(tree, dict):
        return {k: _slice(v, index) for k, v in tree.items()}
    return tree[index]


def drop_last_layer(model, params):
    """(model, params) with the last layer of the decoder stack taken out,
    the other weights as they are: an ssm or moe stack's last layer; a
    hybrid's tail layer, or its last mamba layer of a single site; an
    encdec's last decoder layer; a vlm's last self-attention layer of each
    site."""
    cfg, family = model.cfg, model.cfg.family
    params = dict(params)
    if family in ("ssm", "moe", "dense"):
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        params["layers"] = _slice(params["layers"], slice(0, -1))
    elif family == "encdec":
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        params["decoder"] = _slice(params["decoder"], slice(0, -1))
    elif family == "hybrid":
        every = cfg.hybrid_attn_every
        if cfg.num_layers % every:
            if cfg.num_layers % every == 1:
                del params["tail"]
            else:
                params["tail"] = _slice(params["tail"], slice(0, -1))
            cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        else:
            assert cfg.num_layers == every, "one site only"
            cfg = dataclasses.replace(cfg, num_layers=every - 1,
                                      hybrid_attn_every=every - 1)
            params["sites"] = _slice(params["sites"],
                                     (slice(None), slice(0, -1)))
    elif family == "vlm":
        every = cfg.cross_attn_every
        sites = cfg.num_layers // every
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - sites,
                                  cross_attn_every=every - 1)
        params["self_layers"] = _slice(params["self_layers"],
                                       (slice(None), slice(0, -1)))
    else:
        raise ValueError(family)
    return types.SimpleNamespace(cfg=cfg, module=model.module), params


def _with_cfg(model, **changes):
    return types.SimpleNamespace(
        cfg=dataclasses.replace(model.cfg, **changes), module=model.module)


def swapped_kv(params):
    """Dense params with the K and V projections exchanged."""
    attn = dict(params["layers"]["attn"])
    attn["wk"], attn["wv"] = attn["wv"], attn["wk"]
    return dict(params, layers=dict(params["layers"], attn=attn))


def interleaved_rope(params):
    """Dense params whose Q and K head dimensions are reordered so that
    the model's rope, which rotates the two halves of a head, rotates
    neighbouring pairs instead (the other rope convention): dimension
    2i goes to i and 2i + 1 to half + i."""
    import torch

    attn = dict(params["layers"]["attn"])
    hd = attn["wq"].shape[-1]
    perm = torch.cat([torch.arange(0, hd, 2), torch.arange(1, hd, 2)])
    for k in ("wq", "wk"):
        attn[k] = attn[k][..., perm]
    return dict(params, layers=dict(params["layers"], attn=attn))


def with_qk_norm(params):
    """Dense params with Qwen3's qk-norm weights added at their initial
    value (ones, one per head dimension and layer), for a model read with
    ``qk_norm=True``: the one thing that sets Qwen3's dense path apart
    from Mistral-Large's."""
    import torch

    attn = dict(params["layers"]["attn"])
    layers, hd = attn["wq"].shape[0], attn["wq"].shape[-1]
    for k in ("q_norm", "k_norm"):
        attn[k] = torch.ones((layers, hd), dtype=attn["wq"].dtype,
                             device=attn["wq"].device)
    return dict(params, layers=dict(params["layers"], attn=attn))


def wrong_runs(name, model, params, extras, setting=None, seq_len=None):
    """The wrong runs read beside ``name``'s sound run, as (label, model,
    params, extras): the last layer dropped (:func:`drop_last_layer`), and
    one change of the model's own: Mamba2's D skip term zeroed, Zamba2's
    shared attention block read with head_dim 128 (28 heads), Mixtral at
    the default rope_theta and at one expert a token, SeamlessM4T's
    encoder output from one layer fewer, Llama-3.2-Vision at the default
    rope_theta and, against the gated record, with its gates left at 0;
    Qwen2-0.5B's QKV biases ignored (where the run's ``setting`` sets
    them, ``{"biases": ...}``), Qwen3-8B without its qk-norm,
    Granite-34B with its K and V projections swapped (its one K/V head
    serves all 48 query heads, so no grouping of heads can be wrong) or
    its rope over interleaved pairs (:func:`interleaved_rope`),
    Mistral-Large-123B at the default rope_theta and with Qwen3's
    qk-norm switched on (:func:`with_qk_norm`), Llama-4-Scout without its
    shared expert and,
    where ``seq_len`` crosses its attention_chunk, with the chunked mask
    ignored."""
    import torch

    from repro_torch.config import ModelConfig
    from repro_torch.models import encdec

    default_theta = ModelConfig.__dataclass_fields__["rope_theta"].default
    out = [("last layer dropped",) + drop_last_layer(model, params)
           + (extras,)]
    cfg = model.cfg
    if name == "mamba2_130m":
        layers = dict(params["layers"])
        layers["d_skip"] = torch.zeros_like(layers["d_skip"])
        out.append(("D skip zeroed", model, dict(params, layers=layers),
                    extras))
    if name == "zamba2_7b":
        heads = cfg.num_heads * cfg.resolved_head_dim // 128
        attn = dict(params["shared_attn"]["attn"])
        for k in ("wq", "wk", "wv"):
            attn[k] = attn[k].reshape(attn[k].shape[0], heads, 128)
        attn["wo"] = attn["wo"].reshape(heads, 128, attn["wo"].shape[-1])
        shared = dict(params["shared_attn"], attn=attn)
        out.append(("shared block at head_dim 128",
                    _with_cfg(model, head_dim=128, num_heads=heads,
                              num_kv_heads=heads),
                    dict(params, shared_attn=shared), extras))
    if name in ("mixtral_8x22b", "llama_3_2_vision_90b",
                "mistral_large_123b"):
        out.append((f"rope_theta {default_theta:g}",
                    _with_cfg(model, rope_theta=default_theta), params,
                    extras))
    if name == "mixtral_8x22b":
        out.append(("one expert a token",
                    _with_cfg(model, experts_per_token=1), params, extras))
    if name == "seamless_m4t_medium":
        short = dataclasses.replace(cfg, encoder_layers=cfg.encoder_layers
                                    - 1)
        enc = dict(params, encoder=_slice(params["encoder"], slice(0, -1)))
        with torch.no_grad():
            memory = encdec.encode(enc, extras["feats"], short)
        out.append(("encoder's last layer dropped", model, params,
                    dict(extras, enc_out=memory)))
    if name == "qwen2_0_5b" and isinstance(setting, dict):
        out.append(("QKV biases ignored", _with_cfg(model, qkv_bias=False),
                    params, extras))
    if name == "qwen3_8b":
        out.append(("qk-norm left out", _with_cfg(model, qk_norm=False),
                    params, extras))
    if name == "mistral_large_123b":
        out.append(("qk-norm switched on", _with_cfg(model, qk_norm=True),
                    with_qk_norm(params), extras))
    if name == "granite_34b":
        out.append(("K and V projections swapped", model, swapped_kv(params),
                    extras))
        out.append(("rope over interleaved pairs", model,
                    interleaved_rope(params), extras))
    if name == "llama4_scout_17b_a16e":
        out.append(("shared expert left out",
                    _with_cfg(model, moe_shared_expert=False), params,
                    extras))
        if seq_len and seq_len > cfg.attention_chunk:
            out.append(("chunked mask ignored",
                        _with_cfg(model, attention_chunk=None), params,
                        extras))
    if isinstance(setting, list):
        cross = dict(params["cross_layers"])
        for k in ("gate_attn", "gate_mlp"):
            cross[k] = torch.zeros_like(cross[k])
        out.append(("gates left at 0", model,
                    dict(params, cross_layers=cross), extras))
    return out


def run_setting(want):
    """What a record's run sets after init: its QKV biases' draw
    (``{"biases": (seed, scale)}``), a vlm's gates, or None."""
    if "biases" in want:
        return {"biases": tuple(want["biases"])}
    return want["gates"]


def smoke_argv(arch):
    """The port's CPU serve argv of ``arch``'s SMOKE run, at the prompt
    length the worker's SMOKE record serves."""
    sys.path.insert(0, TESTS)
    import _torch_reference_worker as worker

    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    if arch in worker.SERVE_SMOKE_PROMPT:
        argv += ["--prompt-len", str(worker.SERVE_SMOKE_PROMPT[arch])]
    return argv


def _reference_params(schema, record):
    """The reference's ``init_params(schema, PRNGKey(0))`` as torch
    tensors, leaf by leaf (the worker's ``chunked_materialize``), each
    leaf's init-record elements checked where ``record`` has the leaf."""
    import zlib

    import jax
    import numpy as np
    import torch

    sys.path.insert(0, TESTS)
    import _torch_reference_worker as worker

    from repro.models import params as P
    from repro_torch.utils.tree import tree_flatten_with_paths

    key = jax.random.PRNGKey(0)
    flat = {}
    with worker._chunked_init():
        for path, spec in tree_flatten_with_paths(schema):
            h = zlib.crc32("".join(f"[{k!r}]" for k in path.split("/"))
                           .encode()) % (2 ** 31)
            leaf = np.asarray(P._materialize(P.ParamSpec(
                tuple(spec.shape), tuple(spec.axes), spec.init, spec.scale,
                spec.dtype), jax.random.fold_in(key, h)))
            want = (record or {}).get("leaves", {}).get(path)
            if want is not None:
                got = leaf.reshape(-1)[want["index"]]
                assert np.array_equal(got, np.asarray(want["values"],
                                                      np.float32)), path
            flat[path] = torch.from_numpy(np.array(leaf))
            del leaf
    nested = {}
    for path, leaf in flat.items():
        node = nested
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return nested


def _modality(model, params, batch, prompt_len):
    """The reference's serve draw of the modality inputs (a vlm's
    ``img_feats``, an encdec's frames encoded by the port) as the port's
    ``serve.modality_inputs`` returns them, with the frames kept
    (``feats``) for the wrong runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro_torch.models import encdec

    cfg = model.cfg
    if cfg.family not in ("vlm", "encdec"):
        return {}
    vlm = cfg.family == "vlm"
    shape = (batch, cfg.num_image_tokens if vlm else max(prompt_len, 8),
             cfg.d_model)
    feats = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0),
                                                 2 if vlm else 3),
                              shape, jnp.bfloat16)
    feats = torch.from_numpy(np.asarray(feats, np.float32)).to(
        torch.bfloat16)
    if vlm:
        return {"img_feats": feats}
    with torch.no_grad():
        return {"enc_out": encdec.encode(params, feats, cfg), "feats": feats}


def measure(name):
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    sys.path.insert(0, TESTS)
    import _torch_reference_worker as worker

    worker.apply_shim()
    import chip_smoke

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model

    record = chip_smoke.serve_record(name)
    init_path = os.path.join(TESTS, "torch_reference", f"{name}.json")
    init = chip_smoke._record(name) if os.path.exists(init_path) else None
    first = next(iter(record["runs"].values()))
    if "leaves" in first:       # the served shapes' own init elements
        init = first
    params = None
    for run, want in record["runs"].items():
        argv = want["argv"]
        cfg = dataclasses.replace(get_config(argv[1]),
                                  num_layers=want["num_layers"])
        model = build_model(cfg)
        t0 = time.time()
        if params is None:
            params = _reference_params(model.schema, init)
        setting = run_setting(want)
        run_params = params
        if isinstance(setting, list):
            cross = dict(params["cross_layers"])
            for k, v in zip(("gate_attn", "gate_mlp"), setting):
                cross[k] = torch.full_like(cross[k], v)
            run_params = dict(params, cross_layers=cross)
        if isinstance(setting, dict):
            attn = dict(params["layers"]["attn"])
            names = ("bq", "bk", "bv")
            for k, v in zip(names, chip_smoke.serve_bias_values(
                    [attn[n].shape for n in names], *setting["biases"])):
                attn[k] = torch.from_numpy(v)
            run_params = dict(params, layers=dict(params["layers"],
                                                  attn=attn))
            for k in names:
                want_leaf = want["leaves"][f"layers/attn/{k}"]
                assert np.array_equal(
                    attn[k].reshape(-1)[want_leaf["index"]].numpy(),
                    np.asarray(want_leaf["values"], np.float32)), k
        key = prng.prng_key(0)
        prompts = prng.randint(prng.fold_in(key, 1), (4, 32), 0,
                               cfg.vocab_size, device="cpu")
        extras = _modality(model, run_params, 4, 32)
        serving = {k: v for k, v in extras.items() if k != "feats"}
        t1 = time.time()
        tokens, prefill_s, decode_s = serve.generate(model, run_params,
                                                     prompts, 16, serving)
        t2 = time.time()
        logits = chip_smoke.teacher_forced_logits(model, run_params, want,
                                                  serving)
        got = chip_smoke.serve_readings(tokens, prompts, logits, want)
        print(f"[{run}] draw {t1 - t0:.1f} s, serve {t2 - t1:.1f} s (prefill "
              f"{prefill_s:.2f} s); prompts equal {got['prompts_equal']}; "
              f"tokens differ from step {got['diverged'].tolist()}, first "
              f"near-tie {got['first_tie'].tolist()}; teacher-forced: worst "
              f"{got['worst']:.4g} bf16 ulps, flips {got['flips']} (largest "
              f"gap at a flip {got['flip_gap']:.3g} ulps); recorded gaps "
              f"{np.round(np.asarray(want['gap_ulps']).min(), 2)} ulps at "
              f"the least", flush=True)
        ref_tokens = torch.tensor(want["tokens"])
        for label, wmodel, wparams, wextras in wrong_runs(
                name, model, run_params, extras, setting, seq_len=48):
            wserving = {k: v for k, v in wextras.items() if k != "feats"}
            logits = chip_smoke.teacher_forced_logits(wmodel, wparams, want,
                                                      wserving)
            bad = chip_smoke.serve_readings(ref_tokens, prompts, logits,
                                            want)
            print(f"[{run}] wrong run, {label}: worst {bad['worst']:.4g} "
                  f"bf16 ulps, flips {bad['flips']} (largest gap "
                  f"{bad['flip_gap']:.3g})", flush=True)
            del logits, wparams
        del run_params, extras, serving


@contextlib.contextmanager
def published_theta():
    """The port's ``launch.serve`` reading each SMOKE config at its
    published config's rope_theta, as the worker writes the SMOKE
    records."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    real = serve.get_smoke
    serve.get_smoke = lambda arch: dataclasses.replace(
        real(arch), rope_theta=get_config(arch).rope_theta)
    try:
        yield
    finally:
        serve.get_smoke = real


def smoke_frames(cfg, batch=4, prompt_len=32):
    """The port's serve draw of an encdec's frame embeddings (CPU)."""
    import torch

    from repro_torch.core import prng

    shape = (batch, max(prompt_len, 8), cfg.d_model)
    n = shape[0] * shape[1] * shape[2]
    return prng.normal(prng.fold_in(prng.prng_key(0), 3), n, device="cpu",
                       dtype=torch.bfloat16).reshape(shape)


def measure_smoke():
    import io
    import subprocess
    import tempfile

    sys.path.insert(0, REPO)
    import chip_smoke

    from repro_torch.launch import serve

    runs = list(chip_smoke.SERVE_RUNS) + list(chip_smoke.MULTIMODAL_SERVE_RUNS)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.join(
            TESTS, "_torch_reference_worker.py"), "--write-serve-reference",
            tmp, "--smoke"], env=env, check=True, stdout=subprocess.DEVNULL)
        records = {}
        for name in NAMES:
            with open(os.path.join(tmp, f"serve_{name}.json"),
                      encoding="utf-8") as fh:
                records[name] = json.load(fh)
    outs = {}
    for arch, _, setting in runs:
        run = chip_smoke.serve_run_label(arch, setting)
        want = records[chip_smoke.record_name(arch)]["runs"][run]
        with chip_smoke.serve_init(setting), published_theta(), \
                contextlib.redirect_stdout(io.StringIO()):
            out = outs[run] = serve.run(smoke_argv(arch))
        logits = chip_smoke.teacher_forced_logits(
            out["model"], out["params"], want, out["extras"])
        got = chip_smoke.serve_readings(out["tokens"], out["prompts"],
                                        logits, want)
        print(f"[{run} smoke] tokens differ from step "
              f"{got['diverged'].tolist()}, first near-tie "
              f"{got['first_tie'].tolist()}; worst {got['worst']:.4g} bf16 "
              f"ulps, flips {got['flips']}", flush=True)
        extras = dict(out["extras"])
        if out["model"].cfg.family == "encdec":
            extras["feats"] = smoke_frames(out["model"].cfg)
        for label, model, params, wextras in wrong_runs(
                chip_smoke.record_name(arch), out["model"], out["params"],
                extras, setting, seq_len=want["positions"][-1] + 2):
            logits = chip_smoke.teacher_forced_logits(
                model, params, want,
                {k: v for k, v in wextras.items() if k != "feats"})
            bad = chip_smoke.serve_readings(want["tokens"], out["prompts"],
                                            logits, want)
            print(f"[{run} smoke] wrong run, {label}: worst "
                  f"{bad['worst']:.4g}, flips {bad['flips']}", flush=True)
    run = "llama-3.2-vision-90b-gated"
    want = records["llama_3_2_vision_90b"]["runs"][run]
    out = outs["llama-3.2-vision-90b"]
    logits = chip_smoke.teacher_forced_logits(out["model"], out["params"],
                                              want, out["extras"])
    bad = chip_smoke.serve_readings(want["tokens"], out["prompts"], logits,
                                    want)
    print(f"[{run} smoke] gates left at 0: worst {bad['worst']:.4g}, flips "
          f"{bad['flips']}", flush=True)


def main(argv):
    import resource
    import subprocess

    if argv == ["--smoke"]:
        measure_smoke()
        return 0
    if argv[:1] == ["--one"]:
        t0 = time.time()
        measure(argv[1])
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"{argv[1]}: peak RSS {peak:.2f} GiB, {time.time() - t0:.1f} s",
              flush=True)
        return 0
    for name in argv or NAMES:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, __file__, "--one", name])
        _, status, usage = os.wait4(proc.pid, 0)
        code = os.waitstatus_to_exitcode(status)
        print(f"{name}: peak RSS {usage.ru_maxrss / 2 ** 20:.2f} GiB, "
              f"{time.time() - t0:.1f} s, exit {code}", flush=True)
        if code:
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
