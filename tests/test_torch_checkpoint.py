"""The port's checkpoints against the JAX package's file format
(``repro/checkpoint/msgpack_ckpt.py``, which imports here and runs
in-process): a file written by either package is read by the other with
every array byte-equal (bfloat16 included), the msgpack payload is the
reference's byte for byte, and the compressed file too where both compress
with the same codec.  zstd is used where ``zstandard`` imports, zlib where
it does not; a zstd file without ``zstandard`` raises the reference's
``RuntimeError``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import one_torch_thread  # noqa: E402,F401

from repro_torch.checkpoint import msgpack_ckpt as ours  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402


@pytest.fixture(scope="module")
def params():
    return build_model(get_smoke("mamba2_130m")).init(prng.prng_key(0),
                                                      device="cpu")


def _tree(params):
    """Every node kind of the format: float32, bfloat16, int32 and uint8
    arrays (0-d to 3-d, empty), Python scalars, strings, None, nested
    dicts, lists and tuples, and a model's parameters."""
    rng = np.random.default_rng(0)
    return {
        "arch": "mamba2-smoke", "step": 7, "lr": 3e-4, "flag": True,
        "none": None, "params": params,
        "bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
        "int": torch.arange(-5, 7, dtype=torch.int32).reshape(3, 4),
        "bytes": torch.arange(0, 255, dtype=torch.uint8),
        "scalar": torch.tensor(5, dtype=torch.int32),
        "empty": torch.zeros((0, 3), dtype=torch.float32),
        "seq": [torch.ones(2), ("a", 1.5, -3), [], {"x": torch.zeros(1)}],
    }


def _to_jax(node):
    import jax.numpy as jnp

    if isinstance(node, torch.Tensor):
        if node.dtype == torch.bfloat16:
            return jnp.asarray(node.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(node.numpy())
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_jax(v) for v in node)
    return node


def _assert_same(got, want, path=""):
    """Port tree (tensors) against reference tree (jax arrays): the same
    structure, dtypes named alike and bytes equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif hasattr(want, "dtype") and hasattr(want, "shape"):
        assert isinstance(got, torch.Tensor), path
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape, path
        if got.dtype == torch.bfloat16:
            assert str(w.dtype) == "bfloat16", path
            assert got.view(torch.int16).numpy().tobytes() == w.tobytes(), path
        else:
            assert got.numpy().dtype == w.dtype, path
            assert got.numpy().tobytes() == w.tobytes(), path
    else:
        assert got == want and type(got) is type(want), path


def test_payload_is_the_references_byte_for_byte(params):
    import msgpack

    from repro.checkpoint import msgpack_ckpt as ref

    tree = _tree(params)
    want = msgpack.packb(ref._encode(_to_jax(tree)), use_bin_type=True)
    assert ours.packb(ours._encode(tree)) == want
    assert ours.unpackb(want) == msgpack.unpackb(want, raw=False,
                                                 strict_map_key=False)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_reads_the_ports_file(tmp_path, codec, monkeypatch,
                                       params):
    from repro.checkpoint import msgpack_ckpt as ref

    if codec == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(ours, "zstandard", None)
    tree = _tree(params)
    path = str(tmp_path / "port.ckpt")
    ours.save_checkpoint(path, tree)
    with open(path, "rb") as fh:
        head = fh.read(4)
    assert (head == ours._ZSTD_MAGIC) == (codec == "zstd")
    _assert_same(tree, ref.load_checkpoint(path))


def test_port_reads_the_references_file(tmp_path, params):
    from repro.checkpoint import msgpack_ckpt as ref

    tree = _tree(params)
    path = str(tmp_path / "ref.ckpt")
    ref.save_checkpoint(path, _to_jax(tree))
    got = ours.load_checkpoint(path, device="cpu")
    _assert_same(got, ref.load_checkpoint(path))
    ours_path = str(tmp_path / "port.ckpt")
    ours.save_checkpoint(ours_path, got)
    with open(path, "rb") as a, open(ours_path, "rb") as b:
        ra, rb = a.read(), b.read()
    if ra[:4] == ours._ZSTD_MAGIC and rb[:4] == ours._ZSTD_MAGIC:
        assert ra == rb      # the same zstd frames of the same payload


def test_zstd_file_without_zstandard_raises_the_references_error(
        tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    path = str(tmp_path / "z.ckpt")
    ours.save_checkpoint(path, {"a": 1})
    monkeypatch.setattr(ours, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstd-compressed"):
        ours.load_checkpoint(path, device="cpu")


def test_zlib_file_round_trips_and_loads_on_the_asked_device(
        tmp_path, monkeypatch, params):
    monkeypatch.setattr(ours, "zstandard", None)
    path = str(tmp_path / "z.ckpt")
    tree = _tree(params)
    ours.save_checkpoint(path, tree)
    with open(path, "rb") as fh:
        zlib.decompress(fh.read())
    got = ours.load_checkpoint(path, device="cpu")
    _assert_same(got, _to_jax(tree))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ours.load_checkpoint(path)


@pytest.mark.parametrize("value", [0, 127, 128, 255, 256, 65_535, 65_536,
                                   2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1,
                                   -32, -33, -128, -129, -32_768, -32_769,
                                   -2 ** 31, -2 ** 31 - 1, -2 ** 63])
def test_msgpack_integers_take_the_references_widths(value):
    import msgpack

    want = msgpack.packb(value, use_bin_type=True)
    assert ours.packb(value) == want and ours.unpackb(want) == value


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65_535, 65_536])
def test_msgpack_lengths_take_the_references_widths(n):
    import msgpack

    for obj in ("s" * n, b"b" * n, list(range(n % 300)),
                {str(i): i for i in range(n % 300)}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert ours.packb(obj) == want
        assert ours.unpackb(want) == obj
