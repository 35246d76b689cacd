"""The port's dry-run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) and the step pieces they read
(``launch/steps.py``: ``input_specs``, ``abstract_cache``,
``make_prefill_step``) against the JAX package's.

``repro.launch.roofline``, ``repro.configs`` and ``repro.config`` import
here and run in-process; ``repro.launch.dryrun`` sets XLA's device count
at import and ``repro.models`` does not import in this process, so the
reference's dry-run runs, input stand-ins, abstract caches, prefill steps
and ``SKIPS`` come from one shimmed subprocess (the worker's
``dryrun_parts`` task: its production mesh rebuilt with Auto axes, ROADMAP
queue 3).  Contracts, measured before the bounds were set:

- Exact: ``model_flops``; ``SKIPS``; the shapes and dtypes of every input
  stand-in and abstract cache (every architecture id, the four shapes).
- The counted FLOPs of the dense train step (Qwen2-0.5B, train_4k, 2 and 4
  layers) within ``DENSE_TRAIN_FLOPS`` of the reference's HLO count
  (measured 0.9952 and 0.9825).  Elsewhere the counts differ by design and
  are reported without a bound (``test_counts_beside_the_references``):
  FlopCounterMode counts matmuls where the HLO counts every operation
  (decode: 0.358; Mamba2's SSD: 0.874; Mixtral's routing: 0.466), and
  XLA's cost analysis counts the body of the attention's loop over KV
  chunks once where the port counts every chunk (prefill_32k: 1.73).
  Bytes, collective bytes and bytes per device are reported likewise
  (measured 0.32-9.0x, 0.039-0.99x and 0.33-0.70x the reference's): eager
  ops against XLA's fusions, a placement model against SPMD's partitioner,
  the peak of live tensors against XLA's arguments, outputs and
  temporaries.
- ``roofline_extrapolated`` against the direct count of the same config,
  within 1e-9 relative, for one model of each family (the deepest three
  cut in depth to keep the test short); the hybrid's bytes excepted (its
  probes change the site spacing, and a tail layer moves other bytes than
  a site's: measured 1.7% at Zamba2's full depth), reported.
- ``make_prefill_step`` on the SMOKE models: the last logits within each
  family's logit bound of tests/test_torch_models.py,
  tests/test_torch_families.py and tests/test_torch_multimodal.py, and the
  caches' K and V within the same bf16 ulps of each leaf's largest entry
  (``CACHE_ULPS``), the lengths exact.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    cached_plain_draws, one_torch_thread, start_reference, tree_arrays,
)

from repro_torch.config import INPUT_SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402

RUNS = (dict(arch="qwen2_0_5b", shape="train_4k", layers=2),
        dict(arch="qwen2_0_5b", shape="train_4k", layers=4),
        dict(arch="qwen2_0_5b", shape="decode_32k", layers=2),
        dict(arch="qwen2_0_5b", shape="prefill_32k", layers=2),
        dict(arch="mamba2_130m", shape="train_4k", layers=2),
        dict(arch="mixtral_8x22b", shape="train_4k", layers=2))
DENSE_TRAIN = (0, 1)            # the runs held to DENSE_TRAIN_FLOPS
DENSE_TRAIN_FLOPS = (0.975, 1.005)
# one model per family; the deepest cut in depth (the direct count takes
# one fake-tensor pass per layer)
EXTRAP = {"qwen2_0_5b": None, "mixtral_8x22b": {"num_layers": 8},
          "mamba2_130m": None,
          "zamba2_7b": {"num_layers": 20},
          "seamless_m4t_medium": None,
          "llama_3_2_vision_90b": {"num_layers": 20}}
EXTRAP_SHAPE = ShapeConfig("decode_512", 512, 16, "decode")
EXTRAP_RTOL = 1e-9
PREFILL = {"qwen2_0_5b": 2, "mixtral_8x22b": 3, "mamba2_130m": 3,
           "zamba2_7b": 3, "seamless_m4t_medium": 3,
           "llama_3_2_vision_90b": 3}      # arch: its family's LOGIT_ULPS
CACHE_ULPS = 3
GATES = [0.5, -0.7]     # tests/test_torch_multimodal*.py's


def _prefill_arrays():
    arrays = {}
    rng = np.random.default_rng(5)
    for arch in PREFILL:
        cfg = get_smoke(arch)
        pre = f"prefill/{arch}"
        arrays[f"{pre}/tokens"] = rng.integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32)
        if cfg.family == "vlm":
            arrays[f"{pre}/img_feats"] = rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            arrays[f"{pre}/enc_feats"] = rng.standard_normal(
                (2, 16, cfg.d_model)).astype(np.float32)
    return arrays


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    spec = {"runs": list(RUNS),
            "inputs": [[a, s] for a in ARCH_IDS for s in INPUT_SHAPES],
            "prefill": [dict(arch=a, gates=GATES if get_smoke(a).family
                             == "vlm" else None) for a in PREFILL]}
    job = start_reference(tmp_path_factory.mktemp("dryrun"), "dryrun_parts",
                          spec, _prefill_arrays())
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def _json(reference, key):
    return json.loads(str(reference[key]))


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    """The dry-run's fake process group, destroyed at the module's end."""
    yield
    mesh_lib.release_world()


@pytest.fixture(scope="module")
def port_runs():
    return [dryrun.run_one(case["arch"], case["shape"], verbose=False,
                           cfg_override={"num_layers": case["layers"]})
            for case in RUNS]


# --------------------------------------------------------------------------
# the roofline's formula and terms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_is_the_references_exactly(arch):
    from repro.config import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as ref

    for name in INPUT_SHAPES:
        for chips in (1, 256, 512):
            assert rl.model_flops(get_config(arch), INPUT_SHAPES[name],
                                  n_chips=chips) == \
                ref.model_flops(ref_config(arch), REF_SHAPES[name],
                                n_chips=chips)


def test_roofline_has_the_references_terms_with_the_h100s_constants():
    from repro.launch import roofline as ref

    stats = rl.CollectiveStats({"all-reduce": 7}, {"all-reduce": 1})
    ours = rl.Roofline(flops=3e12, hbm_bytes=2e10, collective_bytes=1e8,
                       collectives=stats, model_flops=2e12)
    theirs = ref.Roofline(flops=3e12, hbm_bytes=2e10, collective_bytes=1e8,
                          collectives=ref.CollectiveStats(
                              {"all-reduce": 7}, {"all-reduce": 1}),
                          model_flops=2e12)
    assert ours.summary().keys() == theirs.summary().keys()
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert ours.t_compute == 3e12 / 989e12
    assert ours.t_memory == 2e10 / 3.35e12
    assert ours.t_collective == 1e8 / 50e9
    assert ours.bottleneck == "memory"
    assert ours.useful_flops_ratio == theirs.useful_flops_ratio
    assert stats.total_bytes == 7
    assert not hasattr(rl, "parse_collectives")


# --------------------------------------------------------------------------
# the counts
# --------------------------------------------------------------------------

def test_decode_reads_the_whole_cache_with_one_host_read_a_layer(port_runs):
    """decode_32k at 2 layers: one host read of the length per attention
    layer, and the step moves at least the whole KV cache per card."""
    run = port_runs[2]
    cfg = get_config("qwen2_0_5b")
    shape = INPUT_SHAPES["decode_32k"]
    assert run.roofline["host_reads"] == 2
    kv = 2 * 2 * shape.global_batch * shape.seq_len * \
        cfg.padded_kv_heads(16) * cfg.resolved_head_dim * 2
    assert run.roofline["hbm_bytes_per_chip"] * 256 >= kv


def test_train_counts_the_gradient_collectives(port_runs):
    coll = port_runs[0].roofline["collective_breakdown"]
    assert coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
    assert coll["all-reduce"] > 0
    decode = port_runs[2].roofline["collective_breakdown"]
    assert decode["reduce-scatter"] == 0


@pytest.mark.parametrize("i", (2, 3))
def test_serving_counts_the_tensor_parallel_all_reduces(port_runs, i):
    """A 2-layer dense prefill and decode on 16x16 all-reduce over the
    model axis once per attention output, MLP output and the embedding:
    2 * layers + 1 times, each the (B, S, D) bf16 activation with the batch
    split over the data axis; the prefill's 32k positions move more than
    the decode's one."""
    case, run = RUNS[i], port_runs[i]
    cfg = get_config(case["arch"])
    shape = INPUT_SHAPES[case["shape"]]
    seq = shape.seq_len if shape.kind == "prefill" else 1
    sites = 2 * case["layers"] + 1
    assert run.roofline["collective_counts"]["all-reduce"] == sites
    assert run.roofline["collective_breakdown"]["all-reduce"] == sites * (
        shape.global_batch * seq * cfg.d_model * 2 // 16)
    assert port_runs[3].roofline["collective_bytes_per_chip"] > \
        port_runs[2].roofline["collective_bytes_per_chip"]


@pytest.mark.parametrize("arch", list(EXTRAP))
def test_extrapolation_equals_the_direct_count(arch):
    res = dryrun.roofline_extrapolated(arch, EXTRAP_SHAPE,
                                       cfg_override=EXTRAP[arch],
                                       verbose=False)
    direct = dryrun.run_one(arch, EXTRAP_SHAPE, cfg_override=EXTRAP[arch],
                            verbose=False)
    gap = dryrun.extrapolation_gap(res, direct)
    assert gap["hlo_flops_per_chip"] <= EXTRAP_RTOL, gap
    assert gap["collective_bytes_per_chip"] <= EXTRAP_RTOL, gap
    if get_config(arch).family != "hybrid":
        assert gap["hbm_bytes_per_chip"] <= EXTRAP_RTOL, gap
    assert res.roofline["model_flops_per_chip"] == \
        direct.roofline["model_flops_per_chip"]


def test_cli_writes_a_result_per_pair_and_skips(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["OK", "SKIP"]
    assert rows[0]["mesh"] == "16x16"
    assert set(rows[0]) == {f.name for f in dataclasses.fields(
        dryrun.DryrunResult)}
    assert "SKIP: pure full attention" in capsys.readouterr().out


def test_smoke_mesh_counts_one_card():
    shape = ShapeConfig("t", 128, 8, "train")
    one = dryrun.run_one("qwen2_0_5b", shape, smoke_mesh=True, fl_bits=4,
                         cfg_override={"num_layers": 2}, verbose=False)
    assert one.status == "OK", one.error
    assert one.mesh == "1x1"
    assert one.roofline["collective_bytes_per_chip"] == 0


# --------------------------------------------------------------------------
# against the reference's subprocess (last, so that it runs beside the
# tests above)
# --------------------------------------------------------------------------

def test_skips_are_the_references(reference):
    want = {tuple(k): v for k, v in _json(reference, "skips")}
    assert dryrun.SKIPS == want


def _shapes(tree):
    return {p: [list(x.shape), str(x.dtype).replace("torch.", "")]
            for p, x in tree_flatten_with_paths(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_abstract_cache_equal_the_reference(reference, arch):
    cfg = get_config(arch)
    model = build_model(cfg, shards=16)
    for name, shape in INPUT_SHAPES.items():
        assert _shapes(steps.input_specs(cfg, shape)) == \
            _json(reference, f"inputs/{arch}/{name}"), name
        cache = steps.abstract_cache(model, shape)
        assert _shapes(cache) == _json(reference, f"acache/{arch}/{name}")
        assert all(isinstance(x, torch._subclasses.FakeTensor)
                   for _, x in tree_flatten_with_paths(cache))
    assert steps.enc_frames(INPUT_SHAPES["train_4k"]) == 1024
    assert steps.enc_frames(ShapeConfig("s", 100, 1, "train")) == 64


def _bf16_ulp(x):
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("arch", list(PREFILL))
def test_prefill_step_matches_the_reference(reference, arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(prng.prng_key(0), device="cpu")
    if cfg.family == "vlm":
        for name, value in zip(("gate_attn", "gate_mlp"), GATES):
            params["cross_layers"][name] = torch.full_like(
                params["cross_layers"][name], value)
    pre = f"prefill/{arch}"
    batch = {k[len(pre) + 1:]: torch.from_numpy(v)
             for k, v in _prefill_arrays().items() if k.startswith(pre + "/")}
    batch = {k: v if k == "tokens" else v.to(torch.bfloat16)
             for k, v in batch.items()}
    b, s = batch["tokens"].shape
    step = steps.make_prefill_step(model, ShapeConfig("p", s, b, "prefill"),
                                   device="cpu")
    logits, caches = step(params, batch)
    want = reference[f"{pre}/out/logits"]
    assert logits.shape == want.shape == (b, 1, cfg.padded_vocab)
    err = np.abs(logits.numpy() - want).max()
    assert err <= PREFILL[arch] * _bf16_ulp(np.abs(want).max()), err
    got = tree_arrays(tree_lib.tree_map(
        lambda x: x.float() if x.dtype == torch.bfloat16 else x, caches),
        f"{pre}/out/cache/")
    assert got.keys() == {k for k in reference
                          if k.startswith(f"{pre}/out/cache/")}
    for key, value in got.items():
        ref = reference[key]
        assert value.shape == ref.shape, key
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(value, ref, err_msg=key)
        else:
            tol = CACHE_ULPS * _bf16_ulp(np.abs(ref).max())
            assert np.abs(value.astype(np.float64) - ref).max() <= tol, key



@pytest.mark.parametrize("i", DENSE_TRAIN)
def test_dense_train_flops_within_the_measured_bound(reference, port_runs,
                                                     i):
    want = _json(reference, f"run/{i}")
    got = port_runs[i]
    assert got.status == want["status"] == "OK", got.error
    ratio = got.roofline["hlo_flops_per_chip"] / \
        want["roofline"]["hlo_flops_per_chip"]
    lo, hi = DENSE_TRAIN_FLOPS
    assert lo <= ratio <= hi, ratio
    assert got.roofline["model_flops_per_chip"] == \
        want["roofline"]["model_flops_per_chip"]


def test_counts_beside_the_references(reference, port_runs):
    """Every run counts finite, positive terms; the ratios to the
    reference's are printed (no bound: the counts differ by design)."""
    for i, case in enumerate(RUNS):
        want, got = _json(reference, f"run/{i}"), port_runs[i]
        assert got.status == "OK", got.error
        ratios = {}
        for key in ("hlo_flops_per_chip", "hbm_bytes_per_chip",
                    "collective_bytes_per_chip"):
            assert np.isfinite(got.roofline[key]) and got.roofline[key] > 0
            ratios[key] = got.roofline[key] / want["roofline"][key]
        ratios["bytes_per_device"] = got.bytes_per_device / \
            want["bytes_per_device"]
        print(case, {k: round(v, 4) for k, v in ratios.items()})
        assert got.roofline["bottleneck"] in ("compute", "memory",
                                              "collective")
