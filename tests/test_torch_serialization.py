"""Port parity: the NDARRAY_V2 ``.params`` container
(``mxnet_tpu_torch/ndarray/serialization.py``, ``nd.save``/``nd.load``)
against the JAX package's writer and reader and against hand-built files.

The container is the repo's declared interchange boundary, so the checks
are exact: the port's writer gives the same bytes as the JAX package's
for the same arrays in every dtype flag (bfloat16 included, with and
without ``ml_dtypes`` importable), named and unnamed; a file either
package writes loads in the other bit for bit; hand-built V1 and V2
blobs, the npz fallback (bool) and a legacy npz load; bad magic, a
sparse blob and a truncated file raise.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import struct
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import serialization as jser
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import serialization as tser

RS = np.random.RandomState(0)
# every dtype the container has a flag for, with its flag
FLAGS = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4,
         "int8": 5, "int64": 6, "bfloat16": 12}
# what the JAX package's NDArrays hold (no float64/int64 without x64)
JAX_ND_DTYPES = ("float32", "float16", "uint8", "int32", "int8",
                 "bfloat16")


def _values(dtype, shape=(3, 5)):
    """Numpy values exact in ``dtype`` (bfloat16 as float32 values that
    round to themselves)."""
    if dtype in ("float32", "float64", "float16"):
        return np.asarray(RS.randn(*shape)).astype(dtype)
    if dtype == "bfloat16":
        v = torch.from_numpy(np.asarray(RS.randn(*shape), np.float32))
        return v.to(torch.bfloat16).float().numpy()
    lo, hi = (0, 255) if dtype == "uint8" else (-100, 100)
    return np.asarray(RS.randint(lo, hi, shape)).astype(dtype)


def _jax_np(a, dtype):
    """The numpy array the JAX package's writer takes for ``dtype``."""
    if dtype == "bfloat16":
        import ml_dtypes

        return a.astype(ml_dtypes.bfloat16)
    return a


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("named", [True, False], ids=["named", "unnamed"])
@pytest.mark.parametrize("dtype", list(FLAGS))
def test_writer_bytes_equal_the_jax_package(tmp_path, dtype, named):
    arrays = [_values(dtype), _values(dtype, (7,)), _values(dtype, ())]
    names = ["arg:w", "aux:running_mean", "s"] if named else []
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jser.save_params(jpath, [_jax_np(a, dtype) for a in arrays], names)
    tser.save_params(tpath, [_torch(a, dtype) for a in arrays], names)
    assert _read(tpath) == _read(jpath)
    # the flag sits after magic, stype, ndim, dims and the context
    with open(tpath, "rb") as f:
        f.read(24 + 4 + 4 + 4 + 8 + 8)
        assert struct.unpack("<i", f.read(4))[0] == FLAGS[dtype]


@pytest.mark.parametrize("dtype", list(FLAGS))
def test_each_package_reads_the_others_file(tmp_path, dtype):
    a = _values(dtype, (4, 6))
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jser.save_params(jpath, [_jax_np(a, dtype)], ["x"])
    tser.save_params(tpath, [_torch(a, dtype)], ["x"])
    (got,), names = tser.load_params(jpath)
    assert names == ["x"] and got.dtype == getattr(torch, dtype)
    assert torch.equal(got, _torch(a, dtype))
    (back,), _ = jser.load_params(tpath)
    assert back.dtype.name == dtype
    np.testing.assert_array_equal(np.asarray(back, np.float64),
                                  np.asarray(a, np.float64))


def test_bfloat16_needs_no_ml_dtypes(tmp_path, monkeypatch):
    """bfloat16 is written and read as raw 16-bit words: with
    ``ml_dtypes`` hidden the bytes and the values stay the same."""
    a = _values("bfloat16", (5, 3))
    jpath = str(tmp_path / "j.params")
    jser.save_params(jpath, [_jax_np(a, "bfloat16")], ["w"])
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    tpath = str(tmp_path / "t.params")
    tser.save_params(tpath, [_torch(a, "bfloat16")], ["w"])
    assert _read(tpath) == _read(jpath)
    (got,), _ = tser.load_params(jpath)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _torch(a, "bfloat16"))


@pytest.mark.parametrize("dtype", JAX_ND_DTYPES)
def test_nd_save_load_across_packages(tmp_path, dtype):
    a = _values(dtype, (3, 4))
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {"a": jmx.nd.array(a).astype(dtype),
                        "b": jmx.nd.array(a[:1]).astype(dtype)})
    with mx.cpu():
        tmp = {"a": mx.nd.array(a, dtype=dtype),
               "b": mx.nd.array(a[:1], dtype=dtype)}
        mx.nd.save(tpath, tmp)
        assert _read(tpath) == _read(jpath)
        got = mx.nd.load(jpath)
    assert sorted(got) == ["a", "b"]
    assert got["a"].data.dtype == getattr(torch, dtype)
    assert got["a"].context == mx.cpu()
    np.testing.assert_array_equal(got["a"].asnumpy().astype(np.float64),
                                  a.astype(np.float64))
    back = jmx.nd.load(tpath)
    np.testing.assert_array_equal(
        np.asarray(back["b"].asnumpy(), np.float64), a[:1].astype(np.float64))


def test_nd_save_list_and_single(tmp_path):
    path = str(tmp_path / "l.params")
    with mx.cpu():
        arrs = [mx.nd.array(_values("float32")),
                mx.nd.array(_values("int32"), dtype="int32")]
        mx.nd.save(path, arrs)
        back = mx.nd.load(path)
        assert isinstance(back, list) and len(back) == 2
        for x, y in zip(back, arrs):
            assert torch.equal(x.data, y.data)
        mx.nd.save(path, arrs[0])
        (one,) = mx.nd.load(path)
        assert torch.equal(one.data, arrs[0].data)
    jl = jmx.nd.load(path)
    np.testing.assert_array_equal(jl[0].asnumpy(), arrs[0].asnumpy())
    with pytest.raises(TypeError):
        mx.nd.save(path, 3)


def _hand_blob(a, flag, v1=False):
    out = struct.pack("<I", 0xF993FAC8 if v1 else 0xF993FAC9)
    if not v1:
        out += struct.pack("<i", 0)
    out += struct.pack("<I", a.ndim) + struct.pack(f"<{a.ndim}I", *a.shape)
    out += struct.pack("<ii", 1, 0) + struct.pack("<i", flag)
    return out + np.ascontiguousarray(a).tobytes()


def _hand_file(path, blobs, names):
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, len(blobs)))
        for b in blobs:
            f.write(b)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            f.write(struct.pack("<Q", len(n)) + n.encode())


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_hand_built_blobs_load(tmp_path, v1):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.array([1, 2, 3], dtype=np.int32)
    path = str(tmp_path / "ref.params")
    _hand_file(path, [_hand_blob(w, 0, v1), _hand_blob(b, 4, v1)],
               ["arg:weight", "arg:bias"])
    with mx.cpu():
        loaded = mx.nd.load(path)
    assert set(loaded) == {"arg:weight", "arg:bias"}
    np.testing.assert_array_equal(loaded["arg:weight"].asnumpy(), w)
    np.testing.assert_array_equal(loaded["arg:bias"].asnumpy(), b)
    assert loaded["arg:bias"].dtype == np.int32
    jl = jmx.nd.load(path)
    np.testing.assert_array_equal(jl["arg:weight"].asnumpy(), w)


def test_bool_falls_back_to_npz_both_ways(tmp_path):
    path, jpath = str(tmp_path / "mask.params"), str(tmp_path / "j.params")
    with mx.cpu():
        mask = mx.nd.array(np.array([[1, 0], [0, 1]], np.float32)) \
            .astype("bool")
        mx.nd.save(path, {"mask": mask})
        assert tser.sniff_format(path) == "npz"
        back = mx.nd.load(path)
        assert back["mask"].dtype == np.bool_
        np.testing.assert_array_equal(back["mask"].asnumpy(),
                                      mask.asnumpy())
        mx.nd.save(path, [mask, mask])
        lst = mx.nd.load(path)
        assert isinstance(lst, list) and len(lst) == 2
        jmx.nd.save(jpath, {"mask": jmx.nd.array(np.eye(2)).astype("bool")})
        got = mx.nd.load(jpath)
    np.testing.assert_array_equal(got["mask"].asnumpy(), np.eye(2, dtype=bool))
    assert jmx.nd.load(path)[0].dtype == np.bool_


def test_legacy_npz_loads(tmp_path):
    path = str(tmp_path / "legacy.params")
    x = RS.rand(4).astype(np.float32)
    with open(path, "wb") as f:
        np.savez(f, k=x)
    with mx.cpu():
        loaded = mx.nd.load(path)
    np.testing.assert_array_equal(loaded["k"].asnumpy(), x)


def test_bad_files_raise(tmp_path):
    junk = str(tmp_path / "junk.params")
    with open(junk, "wb") as f:
        f.write(b"\x01\x23\x45\x67\x89\xab\xcd\xef" * 4)
    with pytest.raises(MXNetError):
        mx.nd.load(junk)
    with pytest.raises(MXNetError, match="not an MXNet .params"):
        tser.load_params(junk)
    sparse = str(tmp_path / "sparse.params")
    blob = _hand_blob(np.zeros(2, np.float32), 0)
    blob = blob[:4] + struct.pack("<i", 1) + blob[8:]  # row_sparse
    _hand_file(sparse, [blob], ["w"])
    with pytest.raises(MXNetError, match="sparse"):
        tser.load_params(sparse)
    short = str(tmp_path / "short.params")
    _hand_file(short, [_hand_blob(np.zeros(4, np.float32), 0)[:-3]], [])
    with pytest.raises(MXNetError, match="truncated"):
        tser.load_params(short)
    with pytest.raises(MXNetError, match="cannot save dtype"):
        tser.save_params(str(tmp_path / "c.params"),
                         [torch.zeros(2, dtype=torch.complex64)], [])


def test_cuda_tensor_written_from_the_host_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _values("bfloat16", (64, 3))
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jser.save_params(jpath, [_jax_np(a, "bfloat16")], ["w"])
    mx.nd.save(tpath, {"w": mx.nd.array(a, dtype="bfloat16",
                                        ctx=mx.gpu(0))})
    assert _read(tpath) == _read(jpath)
    got = mx.nd.load(tpath)["w"]
    assert got.data.is_cuda and got.data.dtype == torch.bfloat16
