"""Read flax msgpack checkpoints without flax or msgpack.

``flax.serialization.to_bytes`` writes a parameter tree as msgpack: nested
maps with string keys, and each array leaf as an ext value of type code 1
whose payload is itself msgpack of ``(shape, dtype name, C-order bytes)``
(flax ``serialization._ndarray_to_bytes``). ``msgpack_restore`` here decodes
exactly that subset into nested dicts of numpy arrays and raises on any other
msgpack type.

``egnn_params_from_tree`` is the weight bridge of the EGNN: it mirrors
``pita_tpu/nets/egnn_fast.py:69-100 extract_params`` (including the Dense
renumbering when ``attention=False``) and returns the state dict of
``pita_torch.nets.egnn.EGNNBackbone``. ``dit_params_from_tree`` does the
same for ``pita_tpu/nets/dit.py``'s DiT3D and returns the state dict of
``pita_torch.nets.dit.DiT3DBackbone``; ``mlp_params_from_tree`` and
``torchmd_et_params_from_tree`` for the MLP and TorchMD-ET backbones.
``trainer_state_from_tree`` extends them to a whole ``pita_tpu`` trainer state (the tree that
``pita_tpu/io/checkpoint.py:_state_pytree`` builds, with numpy leaves) and
returns ``pita_torch.train.trainer.EnergyTempTrainer.state_dict``'s layout.
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


def _dense(sd, name, q, bias=True):
    """A flax Dense (kernel (in, out)) as an ``nn.Linear``'s weight (out, in)."""
    sd[f"{name}.weight"] = torch.as_tensor(np.array(q["kernel"], dtype=np.float32).T.copy())
    if bias:
        sd[f"{name}.bias"] = torch.as_tensor(np.array(q["bias"], dtype=np.float32))


def dit_params_from_tree(tree, n_blocks: int) -> dict:
    """The DiT3DBackbone flax tree as the port's state dict (float32
    tensors). A flax kernel (in, out) becomes a torch weight (out, in); a
    LayerNorm's ``scale`` becomes its ``weight``."""
    p = tree["params"]
    sd = {}
    dense = lambda name, q, bias=True: _dense(sd, name, q, bias)

    def norm(name, q):
        sd[f"{name}.weight"] = torch.as_tensor(np.array(q["scale"], dtype=np.float32))

    dense("embed", p["Dense_0"])
    for emb in ("sigma_map", "sigma_map_temp"):
        if emb in p:
            dense(f"{emb}.mlp0", p[emb]["Dense_0"])
            dense(f"{emb}.mlp1", p[emb]["Dense_1"])
    for i in range(n_blocks):
        q, b = p[f"DDiTBlock_{i}"], f"blocks.{i}"
        dense(f"{b}.ada", q["Dense_0"])
        norm(f"{b}.norm1", q["LayerNorm_0"])
        dense(f"{b}.qkv", q["Dense_1"], bias=False)
        dense(f"{b}.attn_out", q["Dense_2"], bias=False)
        norm(f"{b}.norm2", q["LayerNorm_1"])
        dense(f"{b}.mlp_up", q["Dense_3"])
        dense(f"{b}.mlp_down", q["Dense_4"])
    dense("final_ada", p["Dense_1"])
    norm("final_norm", p["LayerNorm_0"])
    dense("final_out", p["Dense_2"])
    return sd


def mlp_params_from_tree(tree) -> dict:
    """The MLPBackbone flax tree (pita_tpu/nets/mlp.py) as the state dict of
    ``pita_torch.nets.mlp.MLPBackbone``: ``Dense_0`` the input layer,
    ``Dense_1`` the time condition, ``ResidualBlock_{i}/Dense_0`` the
    blocks, ``Dense_2`` the last layer."""
    p = tree["params"]
    sd = {}
    _dense(sd, "inp", p["Dense_0"])
    _dense(sd, "t_cond", p["Dense_1"])
    i = 0
    while f"ResidualBlock_{i}" in p:
        _dense(sd, f"blocks.{i}", p[f"ResidualBlock_{i}"]["Dense_0"])
        i += 1
    _dense(sd, "out", p["Dense_2"])
    return sd


def fab_flow_params_from_tree(tree) -> dict:
    """The RealNVP flax tree of ``pita_tpu.fab.flow`` as the state dict of
    ``pita_torch.fab.flow.RealNVP``: coupling i's ``Dense_0``, ``Dense_1``
    and ``Dense_2`` become ``conditioners.{i}.0``, ``.2`` and ``.4`` (the
    SiLUs sit between them)."""
    p = tree["params"]
    sd = {}
    i = 0
    while f"coupling_{i}" in p:
        for j in range(3):
            _dense(sd, f"conditioners.{i}.{2 * j}", p[f"coupling_{i}"][f"Dense_{j}"])
        i += 1
    return sd


def _layernorm(sd, name, q):
    sd[f"{name}.weight"] = torch.as_tensor(np.array(q["scale"], dtype=np.float32))
    sd[f"{name}.bias"] = torch.as_tensor(np.array(q["bias"], dtype=np.float32))


def torchmd_et_params_from_tree(tree) -> dict:
    """The TorchMDETBackbone flax tree (pita_tpu/nets/torchmd_et.py) as the
    state dict of ``pita_torch.nets.torchmd_et.TorchMDETBackbone``. Flax
    numbers each module's Dense and LayerNorm submodules in call order
    (:66-107, :122-135, :175-207)."""
    p = tree["params"]
    sd = {}
    _dense(sd, "embed", p["Dense_0"])
    _dense(sd, "attr", p["Dense_1"])
    mha = ("mix0", "mix1", "q", "k", "v", "vec_proj", "dk", "dv", "o")
    i = 0
    while f"EquivariantMHA_{i}" in p:
        q = p[f"EquivariantMHA_{i}"]
        for j, name in enumerate(mha):
            _dense(sd, f"layers.{i}.{name}", q[f"Dense_{j}"], bias=name != "vec_proj")
        for j, name in enumerate(("norm_h", "norm_q", "norm_k")):
            if f"LayerNorm_{j}" in q:
                _layernorm(sd, f"layers.{i}.{name}", q[f"LayerNorm_{j}"])
        i += 1
    for b in range(2):
        q = p[f"GatedEquivariantBlock_{b}"]
        for j, name in enumerate(("vec1", "vec2", "mix0", "mix1")):
            _dense(sd, f"head.{b}.{name}", q[f"Dense_{j}"], bias=j >= 2)
    return sd


def net_params_from_tree(tree, n_layers: int, attention: bool = True) -> dict:
    """A backbone's flax tree as the port's state dict: the DiT3D's (with
    ``n_layers`` blocks) when the tree has its ``sigma_map``, TorchMD-ET's
    when it has an ``EquivariantMHA_0``, the EGNN's when it has an
    ``EGCL_0``, else the MLP's."""
    p = tree["params"]
    if "sigma_map" in p:
        return dit_params_from_tree(tree, n_layers)
    if "EquivariantMHA_0" in p:
        return torchmd_et_params_from_tree(tree)
    if "EGCL_0" in p:
        return egnn_params_from_tree(tree, n_layers, attention)
    return mlp_params_from_tree(tree)


def load_egnn_params(blob, n_layers: int, attention: bool = True) -> dict:
    """Bytes (or a uint8 array, as stored in ``bench_lj55.npz``) → state dict."""
    data = blob.tobytes() if isinstance(blob, np.ndarray) else bytes(blob)
    return egnn_params_from_tree(msgpack_restore(data), n_layers, attention)


def _adam_node(opt_state):
    """The optax ScaleByAdamState inside a (nested tuple) optimizer state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            node = _adam_node(sub)
            if node is not None:
                return node
    return None


def trainer_state_from_tree(state, n_layers: int, attention: bool = True) -> dict:
    """A ``pita_tpu`` EnergyTempTrainer's state as numpy arrays → the port's
    trainer state: the score and energy weights, their EMA weights and
    ``num_updates``, Adam's ``count``, ``mu`` and ``nu`` (over the score and
    the energy tree, as optax holds them), the stacked buffers and the epoch.
    ``n_layers`` is the EGNN's layers or the DiT3D's blocks (the MLP and
    TorchMD-ET trees give their own depth; ``net_params_from_tree``). The
    generator's state is not carried over (JAX keys are not torch's)."""
    sd = lambda tree: net_params_from_tree(tree, n_layers, attention)
    adam = _adam_node(state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (mu, nu) in the optimizer state")
    moments = {}
    for which in ("mu", "nu"):
        score_tree, energy_tree = getattr(adam, which)
        moments[which] = {**{f"score.{k}": v for k, v in sd(score_tree).items()},
                          **{f"energy.{k}": v for k, v in sd(energy_tree).items()}}
    b = state["buffers"]
    t = lambda a: torch.as_tensor(np.array(a))
    return {
        "params_score": sd(state["params_score"]),
        "params_energy": sd(state["params_energy"]),
        "ema_score": {"params": sd(state["ema_score"]["params"]),
                      "num_updates": int(state["ema_score"]["num_updates"])},
        "ema_energy": {"params": sd(state["ema_energy"]["params"]),
                       "num_updates": int(state["ema_energy"]["num_updates"])},
        "opt_state": {"count": int(adam.count), **moments},
        "buffers": {"x": t(b["x"]).float(), "energy": t(b["energy"]).float(),
                    "force": t(b["force"]).float(), "pos": t(b["pos"]).long(),
                    "size": t(b["size"]).long()},
        "epoch": int(state["epoch"]),
    }


__all__ = [
    "W_FIELDS", "dit_params_from_tree", "egnn_params_from_tree", "fab_flow_params_from_tree",
    "load_egnn_params",
    "mlp_params_from_tree", "msgpack_restore", "net_params_from_tree",
    "torchmd_et_params_from_tree", "trainer_state_from_tree",
]
