"""The JAX package's ``PNTPU1`` checkpoints, read and written by the port.

Port of ``protnote_tpu/core/checkpoint.py``.  The file is::

    b"PNTPU1\\n"  |  16 ascii digits: meta length  |  JSON meta  |  msgpack tree

The JSON meta carries ``checksum_crc32`` and ``blob_bytes`` of the msgpack
tree, which is what ``flax.serialization.to_bytes`` writes for the train
state.  Neither flax nor the ``msgpack`` package is assumed here, so
:func:`msgpack_unpack` decodes the subset flax writes: maps, arrays, str,
bin, nil, bool, ints, floats and flax's ext types (1: ndarray as a packed
``(shape, dtype name, C-order bytes)`` triple, 2: a complex as a packed
``(real, imag)`` pair, 3: a numpy scalar as an ndarray).  ``bfloat16``
leaves have no numpy type without ml_dtypes; they are read as uint16 and
viewed as ``torch.bfloat16``.

Lists and tuples come back as dicts keyed ``"0".."n-1"``;
:func:`restore_checkpoint` rebuilds them against a template tree from the
port's ``init_*`` functions, with the shape checks of the JAX
``_merge_into_template``.  Entries that the template does not hold (the
optimizer state, ``step``, ``text_params``) are decoded and dropped.

:func:`save_checkpoint` is the writer: :func:`msgpack_pack` encodes a tree
in flax's state-dict layout (lists as ``{"0": ..}`` maps, arrays as ext 1),
which the JAX ``restore_checkpoint`` reads.  It writes synchronously to a
temporary file and renames it into place; the JAX package's asynchronous
writer is not ported.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from protnote_tpu_torch.models.convert import _convert

MAGIC = b"PNTPU1\n"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _BF16Array:
    """A bfloat16 leaf: its bits as uint16 (numpy has no bfloat16)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def to_tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.array(self.bits)).view(torch.bfloat16)


def _ndarray_from_bytes(data: bytes):
    shape, dtype_name, buffer = msgpack_unpack(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        return _BF16Array(np.frombuffer(buffer, dtype=np.uint16).reshape(shape))
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack_unpack(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        return arr if isinstance(arr, _BF16Array) else arr[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object (truncated)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32: size, type, data
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return bytes(self.take(n)).decode()
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def msgpack_unpack(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax.serialization writes)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return out


def read_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """``(stored tree, meta)``: the decoded msgpack tree, its array leaves as
    numpy arrays (bfloat16 as :class:`_BF16Array`), checked against the
    CRC32 and length the meta records."""
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a protnote_tpu checkpoint")
        head = fh.read(16)
        if len(head) != 16 or not head.isdigit():
            raise ValueError(f"{path}: truncated checkpoint header")
        meta_blob = fh.read(int(head))
        try:
            meta = json.loads(meta_blob)
        except ValueError as e:
            raise ValueError(f"{path}: truncated or corrupted checkpoint meta") from e
        blob = fh.read()
    want = meta.get("checksum_crc32")
    if want is not None and zlib.crc32(blob) != want:
        raise ValueError(
            f"{path}: checksum mismatch — truncated or corrupted checkpoint "
            f"({len(blob)} bytes read, {meta.get('blob_bytes')} expected)")
    return msgpack_unpack(blob), meta


def _leaf(stored: Any, template: torch.Tensor, key: Optional[str],
          path: str) -> torch.Tensor:
    if isinstance(stored, dict) and "__msgpack_chunked_array__" in stored:
        raise ValueError(f"{path}: chunked (> 1 GiB) leaves are not read; no "
                         "ProtNote parameter is that large")
    if isinstance(stored, _BF16Array):
        t = stored.to_tensor()
        if key == "kernel" and t.dim() == 3:  # conv: (k, cin, cout) -> (cout, cin, k)
            t = t.permute(2, 1, 0).contiguous()
    elif isinstance(stored, (np.ndarray, np.generic, int, float, bool)):
        t = _convert(np.asarray(stored), key)
    else:
        raise ValueError(f"checkpoint leaf at {path!r} is a {type(stored).__name__}, "
                         "not an array")
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint shape mismatch at {path!r}: "
                         f"{tuple(t.shape)} vs {tuple(template.shape)}")
    return t.to(template.dtype)


def merge_into_template(template: Any, stored: Any, path: str = "",
                        key: Optional[str] = None) -> Any:
    """Overlay stored leaves onto the port's ``template`` tree: dict keys
    only on one side are tolerated (the template's value stays), lists are
    rebuilt from ``{"0": ..}`` dicts with a length check, and each leaf must
    have the template's shape (conv kernels after the layout change).  A
    ``None`` slot of the template (``enc_params`` when the encoder is
    trainable) must be ``None`` in the checkpoint too."""
    if isinstance(template, dict):
        if not isinstance(stored, dict):
            raise ValueError(f"checkpoint structure mismatch at {path!r}")
        return {k: (merge_into_template(v, stored[k], f"{path}/{k}", k)
                    if k in stored else v)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if isinstance(stored, dict):
            items = [stored[str(i)] for i in range(len(stored))]
        elif isinstance(stored, list):
            items = stored
        else:
            raise ValueError(f"checkpoint structure mismatch at {path!r}")
        if len(items) != len(template):
            raise ValueError(f"checkpoint sequence length mismatch at {path!r}: "
                             f"{len(items)} vs {len(template)}")
        merged = [merge_into_template(t, v, f"{path}/{i}")
                  for i, (t, v) in enumerate(zip(template, items))]
        return type(template)(merged)
    if template is None:
        if stored is not None:  # e.g. TRAIN_SEQUENCE_ENCODER differs from the run
            raise ValueError(f"checkpoint structure mismatch at {path!r}: the "
                             "template holds nothing there")
        return None
    return _leaf(stored, template, key, path)


def restore_checkpoint(path: str, template: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(tree, meta)``: the checkpoint at ``path`` in the structure of the
    port's ``template`` (``trainable``/``model_state``/``enc_params``/
    ``enc_state``, CPU tensors), leaves cast to the template's dtypes as the
    JAX ``restore_checkpoint`` does."""
    stored, meta = read_checkpoint(path)
    return merge_into_template(template, stored), meta


# ----------------------------------------------------------------------
# writer


def _pack_len(out: bytearray, n: int, fix: Optional[Tuple[int, int]], codes) -> None:
    """A length header: a fix form ``(first byte, max)`` when it fits, else
    the 8/16/32-bit forms of ``codes`` (None where a form does not exist)."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries/bytes is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                 (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_array(out: bytearray, arr) -> None:
    """flax's ext 1: a packed ``(shape, dtype name, C-order bytes)``."""
    if isinstance(arr, _BF16Array):
        shape, name, data = arr.bits.shape, "bfloat16", np.ascontiguousarray(arr.bits).tobytes()
    else:
        arr = np.asarray(arr)
        shape, name, data = arr.shape, arr.dtype.name, np.ascontiguousarray(arr).tobytes()
    if len(data) > (1 << 30) - (1 << 10):
        raise ValueError("array leaves over 1 GiB would need flax's chunking")
    payload = bytearray([0x93])  # a 3-element array
    _pack(payload, [int(d) for d in shape])
    _pack(payload, name)
    _pack(payload, data)
    _pack_len(out, len(payload), None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", _EXT_NDARRAY)
    out += payload


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _pack_len(out, len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)) and all(
            not isinstance(v, (dict, list, tuple, np.ndarray, _BF16Array)) for v in obj):
        _pack_len(out, len(obj), (0x90, 15), (None, 0xDC, 0xDD))  # an array of scalars
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):  # a tree node: flax writes {"0": ..}
        _pack(out, {str(i): v for i, v in enumerate(obj)})
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 15), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, np.generic, _BF16Array)):
        _pack_array(out, obj)
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} into a checkpoint")


def msgpack_pack(tree: Any) -> bytes:
    """Encode a checkpoint tree (dicts, lists as ``{"0": ..}`` maps, numpy
    arrays, Python scalars, None) as msgpack, the inverse of
    :func:`msgpack_unpack` on what flax writes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save_checkpoint(path: str, tree: Dict[str, Any], epoch: int,
                    best_val_metric: Optional[float] = None) -> None:
    """Write ``tree`` (the JAX train-state layout with numpy leaves, e.g.
    :func:`~protnote_tpu_torch.models.convert.to_jax_tree`) as a ``PNTPU1``
    file: magic, 16-digit meta length, JSON meta (``epoch``,
    ``best_val_metric``, ``checksum_crc32``, ``blob_bytes``), the msgpack
    blob; atomically, through a temporary file in the same directory."""
    blob = msgpack_pack(tree)
    meta = {"epoch": int(epoch),
            "best_val_metric": None if best_val_metric is None else float(best_val_metric),
            "checksum_crc32": zlib.crc32(blob), "blob_bytes": len(blob)}
    meta_blob = json.dumps(meta).encode()
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(MAGIC)
            fh.write(f"{len(meta_blob):016d}".encode())
            fh.write(meta_blob)
            fh.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
