"""Read the bench asset's flax msgpack weights without flax or msgpack.

Frozen copy of ``pita_torch/io/flax_params.py`` at commit dfb8e7f (lines
23-158: the msgpack subset that ``flax.serialization.to_bytes`` writes, and
``egnn_params_from_tree``), so that the benchmark turns the asset into
tensors itself and hands the same tensors to the port and to the reference.
"""

import numpy as np
import torch

_NDARRAY_EXT = 1

# per-layer weight names, in the order of pita_tpu/ops/pallas/egnn_fwd.py:79-82
W_FIELDS = (
    "w_src", "b_src", "w_dst", "w_scal", "w_e2", "b_e2",
    "w_att", "b_att", "w_c1", "b_c1", "w_c2", "w_n1", "b_n1", "w_n2", "b_n2",
)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)


def _ext(code: int, payload: bytes):
    if code != _NDARRAY_EXT:
        raise ValueError(f"msgpack: unsupported ext type code {code}")
    shape, dtype_name, buf = _unpack(_Reader(payload))
    if not isinstance(dtype_name, str) or not isinstance(buf, bytes):
        raise ValueError("msgpack: malformed ndarray ext payload")
    dtype = np.dtype(dtype_name)
    if dtype.kind not in "biuf":
        raise ValueError(f"msgpack: unsupported ndarray dtype {dtype_name}")
    return np.frombuffer(buf, dtype=dtype).reshape(tuple(shape)).copy()


def _unpack(r: _Reader):
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b >= 0xE0:
        return b - 0x100
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):  # bin8/16/32
        return r.take(r.uint(1 << (b - 0xC4)))
    if b in (0xC7, 0xC8, 0xC9):  # ext8/16/32
        n = r.uint(1 << (b - 0xC7))
        code = r.sint(1)
        return _ext(code, r.take(n))
    if 0xCC <= b <= 0xCF:  # uint8..uint64
        return r.uint(1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:  # int8..int64
        return r.sint(1 << (b - 0xD0))
    if 0xD4 <= b <= 0xD8:  # fixext1..fixext16
        code = r.sint(1)
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str8/16/32
        return r.take(r.uint(1 << (b - 0xD9))).decode("utf-8")
    if b in (0xDC, 0xDD):  # array16/32
        return _array(r, r.uint(2 if b == 0xDC else 4))
    if b in (0xDE, 0xDF):  # map16/32
        return _map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _array(r: _Reader, n: int):
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int):
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, str):
            raise ValueError("msgpack: only string map keys are supported")
        out[k] = _unpack(r)
    return out


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts of numpy arrays."""
    r = _Reader(bytes(data))
    tree = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return tree


def egnn_params_from_tree(tree, n_layers: int, attention: bool = True) -> dict:
    """The EGNNBackbone flax tree as the port's state dict (float32 tensors).

    Keys: ``w_emb``, ``b_emb`` and ``layers.{l}.{field}`` for ``W_FIELDS``;
    weights keep the JAX (in, out) layout. Flax numbers Dense submodules in
    call order, so without attention every index after 3 shifts down by one.
    """
    p = tree["params"]
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
    sd = {"w_emb": t(p["Dense_0"]["kernel"]), "b_emb": t(p["Dense_0"]["bias"])}
    off = 0 if attention else -1
    for l in range(n_layers):
        q = p[f"EGCL_{l}"]
        F = q["Dense_3"]["kernel"].shape[1]
        if attention:
            w_att, b_att = q["Dense_4"]["kernel"], q["Dense_4"]["bias"]
        else:
            w_att, b_att = np.zeros((F, 1), np.float32), np.zeros((1,), np.float32)
        fields = dict(
            w_src=q["Dense_0"]["kernel"], b_src=q["Dense_0"]["bias"],
            w_dst=q["Dense_1"]["kernel"],
            w_scal=q["Dense_2"]["kernel"],
            w_e2=q["Dense_3"]["kernel"], b_e2=q["Dense_3"]["bias"],
            w_att=w_att, b_att=b_att,
            w_c1=q[f"Dense_{5 + off}"]["kernel"], b_c1=q[f"Dense_{5 + off}"]["bias"],
            w_c2=q[f"Dense_{6 + off}"]["kernel"],
            w_n1=q[f"Dense_{7 + off}"]["kernel"], b_n1=q[f"Dense_{7 + off}"]["bias"],
            w_n2=q[f"Dense_{8 + off}"]["kernel"], b_n2=q[f"Dense_{8 + off}"]["bias"],
        )
        for f in W_FIELDS:
            sd[f"layers.{l}.{f}"] = t(fields[f])
    return sd
