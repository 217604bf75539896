"""pita_torch.io.flax_params: the msgpack decoder and the weight bridge,
held against flax's own decoder and pita_tpu's extract_params."""

import jax
import numpy as np
import pytest
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets.egnn_fast import extract_params
from pita_torch.io.flax_params import (
    W_FIELDS,
    load_egnn_params,
    msgpack_restore,
)
from torch_threads import one_intra_op_thread  # noqa: F401

ASSET = "pita_tpu/assets/bench_lj55.npz"


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("blob", ["score_params", "energy_params"])
def test_bench_blobs_decode_like_flax(blob):
    data = np.load(ASSET)[blob].tobytes()
    ours = msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    lo, lr = _leaves(ours), _leaves(ref)
    assert len(lo) == len(lr) == 2 + 3 * 15  # embedding + 15 arrays per layer
    for (po, vo), (pr, vr) in zip(lo, lr):
        assert po == pr
        assert vo.dtype == np.asarray(vr).dtype and vo.shape == np.asarray(vr).shape
        np.testing.assert_array_equal(vo, np.asarray(vr))  # bit-exact


@pytest.mark.parametrize("attention", [True, False])
def test_bridge_matches_extract_params(attention):
    """A fresh flax tree, serialized and carried across, reproduces
    extract_params field for field (including the Dense renumbering
    without attention)."""
    mod = JaxEGNN(n_particles=5, hidden_nf=8, n_layers=2, attention=attention)
    x = jax.numpy.zeros((2, 15))
    params = mod.init(jax.random.PRNGKey(3), jax.numpy.zeros((2,)), x, 1.0)
    sd = load_egnn_params(serialization.to_bytes(params), n_layers=2, attention=attention)
    w_emb, b_emb, layers = extract_params(params, 2, attention)
    np.testing.assert_array_equal(sd["w_emb"].numpy(), np.asarray(w_emb))
    np.testing.assert_array_equal(sd["b_emb"].numpy(), np.asarray(b_emb))
    for l, lp in enumerate(layers):
        for f in W_FIELDS:
            np.testing.assert_array_equal(sd[f"layers.{l}.{f}"].numpy(),
                                          np.asarray(getattr(lp, f)))


def test_bench_state_dict_loads_into_backbone():
    from pita_torch.nets import EGNNBackbone

    bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
    bb.load_state_dict(load_egnn_params(np.load(ASSET)["score_params"], 3))
    assert all(not p.requires_grad for p in bb.parameters())


@pytest.mark.parametrize("payload", [
    b"\xca\x00\x00\x00\x00",  # float32: not in flax's subset
    b"\xd4\x02\x00",  # fixext1 with type code 2
    b"\x81\x01\x02",  # integer map key
    b"\x92\x01",  # truncated array
    b"\x01\x02",  # trailing bytes
])
def test_decoder_rejects_what_it_does_not_know(payload):
    with pytest.raises(ValueError):
        msgpack_restore(payload)


def test_decoder_covers_the_subset():
    """Every msgpack form of the subset decodes as flax decodes it."""
    import msgpack

    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    obj = {
        "s" * 40: [None, True, False, 5, 200, 70000, 2 ** 40, -3, -200, -70000,
                   -(2 ** 40)],
        "b": b"\x00" * 300,
        "a": list(range(20)),
        "m": {str(i): i for i in range(20)},
        "x": arr,
    }
    data = serialization.msgpack_serialize(obj)
    ours = msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(ours.pop("x"), ref.pop("x"))
    assert ours == ref
    assert msgpack.unpackb(msgpack.packb(7)) == msgpack_restore(msgpack.packb(7))
    big = msgpack.packb("z" * 70000)
    assert msgpack_restore(big) == "z" * 70000
