"""The port's meshes and sharding rules (``launch/mesh.py``,
``sharding/rules.py``) against the JAX package's, and its
activation-sharding hook (``models/layers.py:constrain``).

``repro.sharding.rules`` imports here and runs in-process on the
``FakeMesh`` of tests/test_sharding_and_roofline.py (the rules read only
``mesh.shape``); ``repro.models`` does not import in this process, so the
reference's full-width schemas (logical axes and shapes) and abstract
caches come from one shimmed subprocess (the worker's ``sharding_parts``
task).  Contracts: every spec equals the reference's ``PartitionSpec``
entry for entry (exact), for every architecture id's full schema at 16x16
and 2x16x16 and for each family's abstract cache at the four shapes; the
port's meshes are ``DeviceMesh``es over torch's fake process group, which
the module takes down at its end; ``constrain`` with a hook that returns
its input leaves the SMOKE dense, encdec and vlm forwards bit-equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    cached_plain_draws, one_torch_thread, start_reference,
)

from repro_torch.config import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402


class FakeMesh:
    """Stands in for a mesh: the rules read only ``.shape``."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}
# one architecture of each family, for the caches
FAMILY_ARCHS = ("qwen2_0_5b", "mixtral_8x22b", "mamba2_130m", "zamba2_7b",
                "seamless_m4t_medium", "llama_3_2_vision_90b")
GATES = (0.5, -0.7)     # tests/test_torch_multimodal*.py's


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    spec = {"archs": list(ARCH_IDS),
            "caches": [[a, s] for a in FAMILY_ARCHS for s in INPUT_SHAPES]}
    job = start_reference(tmp_path_factory.mktemp("sharding"),
                          "sharding_parts", spec)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return {k: json.loads(str(v)) for k, v in reference_job().items()}


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    """The fake process group the meshes build under, destroyed at the
    module's end so that no later test on this worker sees it."""
    yield
    mesh_lib.release_world()


def _ref_rules():
    from repro.sharding import rules as ref

    return ref


# --------------------------------------------------------------------------
# tests/test_sharding_and_roofline.py's cases, on both packages
# --------------------------------------------------------------------------

TRANSLATE_CASES = (
    (("embed", "mlp"), (4096, 12288)),
    (("heads", "kv", "embed"), (32, 128, 4096)),
    (("expert", "embed", "mlp"), (8, 6144, 16384)),
    (("expert", "embed", "mlp"), (16, 5120, 8192)),
    (("vocab", "embed"), (152064, 896)),
    (("mlp", "heads"), (128, 32)),
    (("layers", "embed", "kv"), (24, 896, 64)),
    ((None, "heads"), (3, 17)),
)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("axes,shape", TRANSLATE_CASES)
def test_translate_equals_the_reference(mesh, axes, shape):
    want = _ref_rules().translate(axes, shape, MESHES[mesh])
    got = rules.translate(axes, shape, MESHES[mesh])
    assert isinstance(got, rules.ShardSpec)
    assert tuple(got) == tuple(want)


def test_translate_the_reference_tests_literal_cases():
    """tests/test_sharding_and_roofline.py:32-58, held on the port."""
    m = MESHES["16x16"]
    assert rules.translate(("embed", "mlp"), (4096, 12288), m) == \
        ("data", "model")
    assert rules.translate(("heads", "kv", "embed"), (32, 128, 4096), m) \
        == ("model", None, "data")
    assert rules.translate(("expert", "embed", "mlp"), (8, 6144, 16384),
                           m) == (None, "data", "model")
    assert rules.translate(("expert", "embed", "mlp"), (16, 5120, 8192),
                           m) == ("model", "data", None)
    assert rules.translate(("vocab", "embed"), (152064, 896), m) == \
        ("model", None)
    spec = rules.translate(("mlp", "heads"), (128, 32), m)
    assert spec[0] == "model" and spec[1] is None


def test_batch_axes_activation_and_cache_specs_equal_the_reference():
    """tests/test_sharding_and_roofline.py:61-74 on both packages."""
    ref = _ref_rules()
    for mesh in MESHES.values():
        assert rules.batch_axes(mesh) == ref.batch_axes(mesh)
        assert rules.batch_shard(mesh) == ref.batch_shard(mesh)
        for b in (1, 16, 32, 256):
            for extra in (1, 2):
                assert tuple(rules.activation_specs(mesh, b,
                                                    extra_dims=extra)) \
                    == tuple(ref.activation_specs(mesh, b,
                                                  extra_dims=extra))
        for shape in ((24, 128, 32768, 16, 128), (24, 1, 524288, 16, 128),
                      (24, 1, 5, 16, 128), (3, 24, 32, 64, 14, 64)):
            st = len(shape) - 4
            assert tuple(rules.cache_pspec(mesh, shape, stacked_dims=st)) \
                == tuple(ref.cache_pspec(mesh, shape, stacked_dims=st))
    assert rules.batch_shard(MESHES["2x16x16"]) == 32
    assert rules.cache_pspec(MESHES["16x16"], (24, 1, 524288, 16, 128)) \
        == (None, None, "data", "model", None)
    assert rules.activation_specs(MESHES["2x16x16"], 64) == (
        ("pod", "data"), None)


# --------------------------------------------------------------------------
# full-width schemas and caches against the reference's
# --------------------------------------------------------------------------

def _nest(flat):
    """{'a/b': x} -> {'a': {'b': x}}."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_reference(reference, arch, multi_pod):
    """``param_pspecs`` of the port's schema (its logical axes from
    ``Model.param_logical_specs``) on a ``DeviceMesh`` equals the
    reference's ``param_pspecs`` of its own schema on the same axes, leaf
    by leaf; the logical axes and shapes are the reference's."""
    import jax
    import jax.numpy as jnp

    want_schema = reference[f"schema/{arch}"]
    model = build_model(get_config(arch), shards=16)
    logical = dict(tree_flatten_with_paths(model.param_logical_specs()))
    abstract = dict(tree_flatten_with_paths(model.abstract()))
    assert {p: [list(a), list(abstract[p].shape)]
            for p, a in logical.items()} == want_schema
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    got = dict(tree_flatten_with_paths(rules.param_pspecs(
        model.param_logical_specs(), model.abstract(), mesh)))
    ref_specs = _ref_rules().param_pspecs(
        _nest({p: tuple(a) for p, (a, _) in want_schema.items()}),
        _nest({p: jax.ShapeDtypeStruct(tuple(s), jnp.float32)
               for p, (_, s) in want_schema.items()}),
        MESHES["2x16x16" if multi_pod else "16x16"])
    want = dict(jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0])
    want = {"/".join(k.key for k in path): spec for path, spec in want.items()}
    assert got.keys() == want.keys()
    for p in got:
        assert tuple(got[p]) == tuple(want[p]), p


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_pspec_of_each_familys_abstract_cache(reference, arch, shape):
    """The port's abstract cache has the reference's shapes and dtypes, and
    ``cache_pspec`` of each (stack..., B, S, H, D) leaf equals the
    reference's on both meshes."""
    want = reference[f"cache/{arch}/{shape}"]
    model = build_model(get_config(arch), shards=16)
    cache = dict(tree_flatten_with_paths(
        steps.abstract_cache(model, INPUT_SHAPES[shape])))
    assert {p: [list(x.shape), str(x.dtype).replace("torch.", "")]
            for p, x in cache.items()} == want
    ref = _ref_rules()
    for p, (dims, _) in want.items():
        if len(dims) < 4:
            continue
        for mesh in MESHES.values():
            st = len(dims) - 4
            assert tuple(rules.cache_pspec(mesh, tuple(dims),
                                           stacked_dims=st)) \
                == tuple(ref.cache_pspec(mesh, tuple(dims),
                                         stacked_dims=st)), (p, mesh.shape)


# --------------------------------------------------------------------------
# meshes and placements
# --------------------------------------------------------------------------

def test_meshes_have_the_references_names_and_shapes():
    from torch.distributed.device_mesh import DeviceMesh

    for multi_pod, shape, names in (
            (False, (16, 16), ("data", "model")),
            (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        assert isinstance(mesh, DeviceMesh)
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == names
        assert mesh.size() == int(np.prod(shape))
        assert rules.axis_sizes(mesh) == dict(zip(names, shape))
    smoke = mesh_lib.make_smoke_mesh()
    assert tuple(smoke.shape) == (1, 1)
    assert smoke.mesh_dim_names == ("data", "model")
    cell = mesh_lib.cell_mesh(1, device="cpu")
    assert cell.mesh_dim_names == (rules.CELL_AXIS,) == ("cell",)


def test_cell_mesh_raises_the_references_error():
    """Beyond the card count (1 on the CPU, as the reference's
    ``jax.local_device_count()`` is here) both raise the same message."""
    from repro.launch.mesh import cell_mesh as ref_cell_mesh

    for shards in (0, 2):
        with pytest.raises(ValueError) as ours:
            mesh_lib.cell_mesh(shards, device="cpu")
        with pytest.raises(ValueError) as theirs:
            ref_cell_mesh(shards)
        assert str(ours.value) == str(theirs.value)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    pod = MESHES["2x16x16"]
    assert rules.ShardSpec("data", "model").placements(pod) == (
        Replicate(), Shard(0), Shard(1))
    assert rules.ShardSpec(("pod", "data"), None).placements(pod) == (
        Shard(0), Shard(0), Replicate())
    assert rules.ShardSpec(None, "model", None).placements(
        MESHES["16x16"]) == (Replicate(), Shard(1))
    assert rules.ShardSpec(("pod", "data"), "model").shard_factor(pod) == 512
    assert rules.ShardSpec(None, None).shard_factor(pod) == 1


# --------------------------------------------------------------------------
# the activation-sharding hook
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("qwen2_0_5b", "seamless_m4t_medium",
                                  "llama_3_2_vision_90b"))
def test_constrain_hook_that_returns_its_input_changes_no_bit(arch):
    """The SMOKE forward (a vlm with its gates set, so its cross layers
    act) is the same to the bit with and without a hook that returns its
    input; the hook sees the reference's kinds at its sites, and the
    partial-sum flag at the row-parallel ones."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(prng.prng_key(0), device="cpu")
    if cfg.family == "vlm":
        for name, value in zip(("gate_attn", "gate_mlp"), GATES):
            params["cross_layers"][name] = torch.full_like(
                params["cross_layers"][name], value)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["img_feats"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model))).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["enc_feats"] = torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model))).to(torch.bfloat16)
    plain = model.forward(params, batch)[0]
    kinds = []

    def hook(x, kind, partial_sum):
        kinds.append((kind, partial_sum))
        return x

    layers.set_activation_sharding(hook)
    try:
        hooked = model.forward(params, batch)[0]
    finally:
        layers.set_activation_sharding(None)
    assert set(kinds) == {("heads", False), ("residual", False),
                          ("residual", True)}
    assert torch.equal(plain.view(torch.int32), hooked.view(torch.int32))
