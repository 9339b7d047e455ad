"""Reference binary ``.params`` serialization (NDARRAY_V2).

The port's own copy of ``mxnet_tpu/ndarray/serialization.py``, over
``torch.Tensor`` instead of numpy arrays: the MXNet 1.x NDArray file
container (reference: ``src/ndarray/ndarray.cc`` ``NDArray::Save/Load``
and the ``MXNDArraySave`` list container in ``src/c_api/c_api.cc``). It
is one of the repo's declared compatibility boundaries: a ``.params``
file written by either package, or by reference MXNet, loads in the
others, and both packages write the same bytes for the same arrays.

Layout (little-endian throughout; dmlc::Stream conventions):

  file container (NDArray::Save(fo, data, names)):
    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  count                  -- dmlc vector<NDArray> serializer
    NDArray blobs x count
    uint64  name_count             -- dmlc vector<string> serializer
    { uint64 len; bytes } x name_count

  dense NDArray blob (save_v2):
    uint32  NDARRAY_V2_MAGIC = 0xF993FAC9
    int32   storage type           -- kDefaultStorage = 0
    uint32  ndim
    uint32  dims[ndim]
    int32   dev_type; int32 dev_id -- Context::Save (always cpu(0))
    int32   type_flag              -- mshadow dtype enum
    bytes   raw data (C order)

Tensors are written from the host (a CUDA tensor is copied to the CPU
first) and read back as CPU tensors. bfloat16 (flag 12) is written and
read as its raw 16-bit words (``Tensor.view(torch.int16)``), so it needs
no numpy bfloat16 type. Legacy V1 blobs (magic 0xF993FAC8: no
storage-type field) and V3 blobs (int64 dims) are accepted on read.
Sparse (row_sparse/csr) blobs raise.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..base import MXNetError

MAGIC_LIST = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA

# mshadow type_flag enum (mshadow/base.h); 12 = bfloat16 (1.8+ oneDNN)
_TYPE_FLAG_TO_TORCH = {
    0: torch.float32, 1: torch.float64, 2: torch.float16, 3: torch.uint8,
    4: torch.int32, 5: torch.int8, 6: torch.int64,
}
_TORCH_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_TORCH.items()}
_BF16_FLAG = 12


def flag_of(dtype) -> int:
    """The mshadow type flag of a torch dtype; ``MXNetError`` for a dtype
    the container cannot hold (bool, for one)."""
    if dtype == torch.bfloat16:
        return _BF16_FLAG
    try:
        return _TORCH_TO_TYPE_FLAG[dtype]
    except KeyError:
        raise MXNetError(f"cannot save dtype {dtype} to NDARRAY_V2")


def _write_blob(f, t):
    t = t.detach().cpu().contiguous()
    flag = flag_of(t.dtype)
    f.write(struct.pack("<I", NDARRAY_V2_MAGIC))
    f.write(struct.pack("<i", 0))  # kDefaultStorage
    f.write(struct.pack("<I", t.dim()))
    f.write(struct.pack(f"<{t.dim()}I", *t.shape))
    f.write(struct.pack("<ii", 1, 0))  # Context: cpu(=1 in DeviceType), id 0
    f.write(struct.pack("<i", flag))
    raw = t.view(torch.int16) if flag == _BF16_FLAG else t
    f.write(raw.numpy().tobytes())


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise MXNetError("truncated NDArray blob")
    return b


def _read_blob(f):
    (magic,) = struct.unpack("<I", _read_exact(f, 4))
    if magic == NDARRAY_V2_MAGIC or magic == NDARRAY_V3_MAGIC:
        (stype,) = struct.unpack("<i", _read_exact(f, 4))
        if stype not in (0, -1):  # kDefaultStorage / kUndefined
            raise MXNetError(
                f"sparse NDArray blobs (stype {stype}) are not supported by "
                "the binary .params reader; use the npz path for sparse")
    elif magic != NDARRAY_V1_MAGIC:  # V1: no storage-type field
        raise MXNetError(f"not an NDArray blob (magic {magic:#x})")
    dim_fmt = "<q" if magic == NDARRAY_V3_MAGIC else "<I"
    dim_sz = 8 if magic == NDARRAY_V3_MAGIC else 4
    (ndim,) = struct.unpack("<I", _read_exact(f, 4))
    if ndim > 32:
        raise MXNetError(f"implausible ndim {ndim} in NDArray blob")
    shape = tuple(
        struct.unpack(dim_fmt, _read_exact(f, dim_sz))[0] for _ in range(ndim))
    struct.unpack("<ii", _read_exact(f, 8))  # context, ignored
    (flag,) = struct.unpack("<i", _read_exact(f, 4))
    if flag == _BF16_FLAG:
        dtype = torch.int16
    elif flag in _TYPE_FLAG_TO_TORCH:
        dtype = _TYPE_FLAG_TO_TORCH[flag]
    else:
        raise MXNetError(f"unsupported dtype flag {flag} in NDArray blob")
    count = 1
    for s in shape:
        count *= s
    item = torch.empty((), dtype=dtype).element_size()
    data = _read_exact(f, count * item)
    np_dtype = np.dtype(str(dtype).split(".")[1])
    t = torch.from_numpy(
        np.frombuffer(data, dtype=np_dtype).reshape(shape).copy())
    return t.view(torch.bfloat16) if flag == _BF16_FLAG else t


def save_params(fname, tensors, names):
    """Write the reference list container. ``names`` may be empty (the
    reference writes positional lists that way). Writes via a temp file +
    rename so a failed save never leaves a truncated container behind."""
    tmp = f"{fname}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<QQ", MAGIC_LIST, 0))
            f.write(struct.pack("<Q", len(tensors)))
            for t in tensors:
                _write_blob(f, t)
            f.write(struct.pack("<Q", len(names)))
            for n in names:
                nb = n.encode("utf-8")
                f.write(struct.pack("<Q", len(nb)))
                f.write(nb)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_params(fname):
    """Read the reference list container -> (list of CPU tensors, list of
    names)."""
    with open(fname, "rb") as f:
        magic, _ = struct.unpack("<QQ", _read_exact(f, 16))
        if magic != MAGIC_LIST:
            raise MXNetError(
                f"not an MXNet .params file (magic {magic:#x}, want 0x112)")
        (count,) = struct.unpack("<Q", _read_exact(f, 8))
        tensors = [_read_blob(f) for _ in range(count)]
        (ncount,) = struct.unpack("<Q", _read_exact(f, 8))
        names = []
        for _ in range(ncount):
            (ln,) = struct.unpack("<Q", _read_exact(f, 8))
            names.append(_read_exact(f, ln).decode("utf-8"))
    return tensors, names


def sniff_format(fname):
    """'ndarray_v2' | 'npz' | 'unknown' by magic bytes."""
    with open(fname, "rb") as f:
        head = f.read(8)
    if len(head) == 8 and struct.unpack("<Q", head)[0] == MAGIC_LIST:
        return "ndarray_v2"
    if head[:2] == b"PK":  # zip container (np.savez)
        return "npz"
    return "unknown"
