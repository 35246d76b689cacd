"""Every public name of the JAX package has a counterpart in the port.

The top-level public names of each module of ``src/repro/`` (its
functions, classes and assigned constants; in an ``__init__.py`` also the
names it re-exports) are read with ``ast``, without importing either
package, and each must be defined at the same place in ``src/repro_torch/``
under the same name, under the name RENAMED gives, or be listed in
UNPORTABLE with the reason no torch counterpart can exist.  The names
that came last (``tree_zeros_like``, LeNet's ``schema`` and ``loss_fn``)
are held to the reference here; the others in the test files of their
modules (tests/test_torch_control_plane.py, test_torch_tdma.py,
test_torch_policies.py, test_torch_scan.py).
"""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import REPO  # noqa: E402

REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

_PALLAS = ("a Pallas kernel body; its counterpart is the hand-written CUDA "
           "kernel in src/repro_torch/kernels/csrc/ behind the module's "
           "wrapper")
_TILE = "a Pallas tile constant; the CUDA kernels choose their own tiling"
# (module, name) -> why no torch counterpart can exist; "*" is the module
UNPORTABLE = {
    ("core/rates_jax.py", "*"): (
        "the jit and shard_map bodies of the device greedy; "
        "core/rates_device.py does their work on torch tensors"),
    ("kernels/aggregate.py", "weighted_aggregate_pallas"): _PALLAS,
    ("kernels/aggregate.py", "ota_aggregate_pallas"): _PALLAS,
    ("kernels/dorefa.py", "quantize_codes_pallas"): _PALLAS,
    ("kernels/dorefa.py", "dequantize_codes_pallas"): _PALLAS,
    ("kernels/dorefa.py", "quantize_dequantize_pallas"): _PALLAS,
    ("kernels/flash_decode.py", "flash_decode_pallas"): _PALLAS,
    ("kernels/sic_rates.py", "sic_weighted_rates_pallas"): _PALLAS,
    ("kernels/aggregate.py", "TILE_ELEMS"): _TILE,
    ("kernels/aggregate.py", "DEFAULT_CHUNK_ELEMS"): _TILE,
    ("kernels/dorefa.py", "LANE"): _TILE,
    ("kernels/dorefa.py", "BLOCK_ROWS"): _TILE,
    ("kernels/sic_rates.py", "LANE"): _TILE,
    ("kernels/sic_rates.py", "BLOCK_V"): _TILE,
    ("kernels/sic_rates.py", "K_PAD"): _TILE,
    ("launch/roofline.py", "analyze"): (
        "reads the cost analysis of XLA's compiled HLO; the port's "
        "launch/dryrun.py counts bytes and flops on fake tensors"),
    ("launch/roofline.py", "parse_collectives"): (
        "parses collectives out of XLA's HLO text; the port has no HLO"),
}
# (module, name) -> the port's name for the same thing at the same place
RENAMED = {
    ("sharding/vertex.py", "vertex_mesh"): "vertex_devices",
    ("sharding/__init__.py", "vertex_mesh"): "vertex_devices",
}


def public_names(root):
    """{module path relative to ``root``: {public name: line}}: the
    top-level functions, classes and assignments of every module, and the
    names an ``__init__.py`` imports from the package."""
    out = {}
    for directory, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(directory, fname)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            names = {}
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    names[node.name] = node.lineno
                elif isinstance(node, ast.Assign):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            names[target.id] = node.lineno
                elif (isinstance(node, ast.AnnAssign)
                      and isinstance(node.target, ast.Name)):
                    names[node.target.id] = node.lineno
                elif (fname == "__init__.py"
                      and isinstance(node, ast.ImportFrom)
                      and node.level == 0 and node.module != "__future__"):
                    for alias in node.names:
                        names[alias.asname or alias.name] = node.lineno
            out[os.path.relpath(path, root).replace(os.sep, "/")] = {
                k: v for k, v in names.items() if not k.startswith("_")}
    return out


@pytest.fixture(scope="module")
def names():
    return public_names(REF), public_names(PORT)


def test_every_public_name_of_the_reference_has_a_counterpart(names):
    ref, port = names
    missing = []
    for module, defined in sorted(ref.items()):
        if (module, "*") in UNPORTABLE:
            continue
        have = port.get(module, {})
        for name, line in sorted(defined.items()):
            if (module, name) in UNPORTABLE:
                continue
            if RENAMED.get((module, name), name) not in have:
                missing.append(f"src/repro/{module}:{line} {name}")
    assert not missing, missing


def test_every_listed_exception_is_still_a_reference_name(names):
    """No stale entry: each unportable or renamed name is a public name of
    the reference, each unportable module a module of it that the port
    does not have, and each renamed name defined by the port."""
    ref, port = names
    for module, name in UNPORTABLE:
        assert module in ref, module
        if name == "*":
            assert module not in port, module
        else:
            assert name in ref[module], (module, name)
            assert name not in port.get(module, {}), (module, name)
    for (module, name), new in RENAMED.items():
        assert name in ref[module] and new in port[module], (module, name)
    assert all(len(why) > 20 for why in UNPORTABLE.values())


def test_tree_zeros_like_matches_the_reference():
    """``tree_zeros_like``, exported from ``repro_torch.utils`` as the
    reference exports it: zeros of each leaf's shape and dtype, on its
    device, as the reference's on the same tree."""
    from repro.utils import tree_zeros_like as ref_zeros

    from repro_torch.utils import tree_zeros_like

    tree = {"b": {"w": torch.randn(3, 4),
                  "n": torch.arange(5, dtype=torch.int32)},
            "a": torch.ones(2, dtype=torch.bfloat16)}
    want = ref_zeros({"b": {"w": jnp.ones((3, 4)),
                            "n": jnp.arange(5, dtype=jnp.int32)},
                      "a": jnp.ones(2, jnp.bfloat16)})
    got = tree_zeros_like(tree)
    for path in (("b", "w"), ("b", "n"), ("a",)):
        g, w, src = got, want, tree
        for k in path:
            g, w, src = g[k], w[k], src[k]
        assert g.dtype == src.dtype and g.device == src.device
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert g.shape == src.shape == w.shape
        assert not bool(g.any()) and not bool(np.asarray(w).any())


def test_lenet_schema_and_loss_match_the_reference(tmp_path):
    """LeNet's ``schema`` equals the reference's spec for spec, and
    ``loss_fn`` on the same weights and batch its loss within float32
    summation error (the reference's ``repro.models`` imports only in the
    shimmed worker)."""
    import json

    from test_torch_harness import run_reference

    from repro_torch.models import lenet
    from repro_torch.utils.tree import tree_flatten_with_paths

    rng = np.random.default_rng(0)
    arrays = {f"p/{name}/{leaf}": a for name, i, o in lenet.LAYERS
              for leaf, a in (("w", rng.normal(0, 0.05, (i, o))),
                              ("b", rng.normal(0, 0.05, o)))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    arrays["x"] = rng.uniform(0, 1, (32, 784)).astype(np.float32)
    arrays["y"] = rng.integers(0, 10, 32).astype(np.int32)
    want = run_reference(tmp_path, "lenet_parts", {}, arrays)
    got = tree_flatten_with_paths(lenet.schema())
    assert sorted(f"schema/{p}" for p, _ in got) == sorted(
        k for k in want if k.startswith("schema/"))
    for path, spec in got:
        assert [list(spec.shape), list(spec.axes), spec.init, spec.scale,
                spec.dtype] == json.loads(str(want[f"schema/{path}"]))
    params = {}
    for name, _, _ in lenet.LAYERS:
        params[name] = {leaf: torch.from_numpy(arrays[f"p/{name}/{leaf}"])
                        for leaf in ("w", "b")}
    loss = lenet.loss_fn(params, {"x": torch.from_numpy(arrays["x"]),
                                  "y": torch.from_numpy(arrays["y"])})
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=2e-6)
