"""RecordIO container format (reference: ``python/mxnet/recordio.py``).

The port's copy of ``mxnet_tpu/recordio.py``: dmlc-core's RecordIO
wire layout (magic ``0xced7230a``, a length word, the payload padded to 4
bytes) and the ``IRHeader`` image-record header. A pack written by either
package is byte-identical to the other's and reads in both; the native
pipeline (``_native.py``) reads the same files.
"""

from __future__ import annotations

import collections
import os
import struct

import numpy as np

from .base import MXNetError

_MAGIC = 0xCED7230A
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: ``MXRecordIO``).
    ``flag`` is ``"r"`` or ``"w"``."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag}")
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False
            self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if d.get("flag") is not None:
            self.open()

    def _check_pid(self, allow_reset=False):
        # a handle inherited by a forked process is reopened (reading) or
        # refused (writing), as the reference does for its C handles
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise MXNetError("RecordIO handle used in a forked process")

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        if not self.writable:
            raise MXNetError(f"{self.uri} is open for reading")
        self._check_pid()
        self.handle.write(struct.pack("<II", _MAGIC, len(buf) & _LEN_MASK))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise MXNetError(f"{self.uri} is open for writing")
        self._check_pid(allow_reset=True)
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"Invalid RecordIO magic {magic:#x} in {self.uri}")
        length = lrec & _LEN_MASK
        buf = self.handle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        if self.writable:
            raise MXNetError(f"{self.uri} is open for writing")
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` sidecar of ``key<TAB>offset`` lines
    (reference: ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, self.flag)
        if not self.writable:
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                if len(line) < 2:
                    continue
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        if self.writable:
            raise MXNetError(f"{self.uri} is open for writing")
        self._check_pid(allow_reset=True)
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# the names gluon.data uses
RecordIO = MXRecordIO
IndexedRecordIO = MXIndexedRecordIO

IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an ``IRHeader`` and a payload into one record (reference:
    ``recordio.pack``); a non-scalar label is stored after the header
    as float32, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """A record's ``(IRHeader, payload)``."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[: flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC image (Pillow) and pack it (reference:
    ``recordio.pack_img``)."""
    from .image import imencode

    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s, iscolor=-1):
    """A record's ``(IRHeader, HWC uint8 numpy image)``; the channels in
    BGR order, as the reference's OpenCV decode gave them."""
    header, img_bytes = unpack(s)
    from .image import imdecode

    img = imdecode(img_bytes, flag=1 if iscolor != 0 else 0, to_rgb=False)
    return header, img.asnumpy()
