"""The port's data-set plumbing (pita_torch.io.datamodule) against
pita_tpu.io.datamodule, the ALP target's data_url path, and the debug hooks
(pita_torch.utils.debug), on the CPU. No test reaches another host: the
downloads read file:// URLs or a closed port on this one."""

import hashlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_torch.io.datamodule import (com_energy_correction, download_dataset,
                                      importance_weights, plot_reweighted_histograms)
from pita_torch.targets import GMM40, LJ13, ALPEnergy
from pita_torch.utils.debug import detect_anomaly, profile_trace
from pita_torch.utils.tracing import span
from pita_tpu.io import datamodule as jdm
from pita_tpu.targets import GMM40 as JaxGMM40
from pita_tpu.targets import LJ13 as JaxLJ13
from torch_threads import one_intra_op_thread  # noqa: F401


def test_download_existing_file_verifies_checksum(tmp_path):
    """tests/test_datamodule.py:20-27: an existing file is kept and its
    SHA-256 checked."""
    p = tmp_path / "data.npy"
    np.save(p, np.ones(3))
    digest = hashlib.sha256(p.read_bytes()).hexdigest()
    assert download_dataset("http://unused", str(p), sha256=digest) == str(p)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        download_dataset("http://unused", str(p), sha256="0" * 64)


def test_download_without_network_raises_actionable_error(tmp_path):
    with pytest.raises(RuntimeError, match="download failed"):
        download_dataset("http://127.0.0.1:1/none.npy", str(tmp_path / "none.npy"), timeout=0.2)
    assert not os.path.exists(tmp_path / "none.npy")


def test_download_fetches_a_url_and_refuses_a_bad_checksum(tmp_path):
    """A file:// URL is fetched to the path; with a wrong checksum nothing
    is left behind."""
    src = tmp_path / "src.npy"
    np.save(src, np.arange(4.0))
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    dst = tmp_path / "sub" / "dst.npy"
    assert download_dataset(src.as_uri(), str(dst), sha256=digest) == str(dst)
    np.testing.assert_array_equal(np.load(dst), np.arange(4.0))
    bad = tmp_path / "bad.npy"
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        download_dataset(src.as_uri(), str(bad), sha256="0" * 64)
    assert not bad.exists() and not (tmp_path / "bad.npy.part").exists()


def test_com_energy_correction_matches_jax():
    """Random CoMs of 16 samples of 4 particles in 3-D, and the closed form
    of tests/test_datamodule.py:36-45: within 1e-6 relative."""
    x = (np.random.default_rng(0).normal(size=(16, 12)) * 0.7).astype(np.float32)
    for sigma in (0.5, 0.1):
        np.testing.assert_allclose(
            com_energy_correction(torch.as_tensor(x), 4, 3, sigma).numpy(),
            np.asarray(jdm.com_energy_correction(jnp.asarray(x), 4, 3, sigma)), rtol=1e-6)
    one = torch.tensor([1.0, 0.0, 0.0]).repeat(1, 4)
    want = 1.0 / (2 * 0.25) - math.log(1.0 / (math.sqrt(2) * 0.125 * math.gamma(1.5)))
    assert float(com_energy_correction(one, 4, 3, 0.5)[0]) == pytest.approx(want, rel=1e-6)


def test_importance_weights_match_jax():
    """GMM-40 with arbitrary proposal log-densities (weights within 1e-5 of
    the largest), and LJ13 with the CoM correction (within 1e-4: its f32
    energies, sums of 78 pair terms taken in another order, differ by
    ~1e-5 nats, which the softmax passes on as relative error); log q =
    log p gives uniform weights."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 2)) * 20).astype(np.float32)
    lq = rng.normal(size=64).astype(np.float32)
    got = importance_weights(GMM40(), torch.as_tensor(x), torch.as_tensor(lq)).numpy()
    ref = np.asarray(jax.jit(lambda a, b: jdm.importance_weights(JaxGMM40(), a, b))(x, lq))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())
    g = GMM40()
    uniform = importance_weights(g, torch.as_tensor(x), g.log_prob(torch.as_tensor(x)))
    np.testing.assert_allclose(uniform.numpy(), 1.0 / 64, rtol=1e-4)
    side = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)[:13]
    xl = (side[None] * 1.1 + 0.05 * rng.normal(size=(32, 13, 3)) + 0.1 * rng.normal(
        size=(32, 1, 3))).reshape(32, 39).astype(np.float32)
    lq = rng.normal(size=32).astype(np.float32)
    got = importance_weights(LJ13(), torch.as_tensor(xl), torch.as_tensor(lq),
                             use_com_energy=True, proposal_com_std=0.1).numpy()
    ref = np.asarray(jax.jit(lambda a, b: jdm.importance_weights(
        JaxLJ13(), a, b, use_com_energy=True, proposal_com_std=0.1))(xl, lq))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * ref.max())


def test_plot_reweighted_histograms(tmp_path):
    """tests/test_datamodule.py:60-73: LJ13 with the CoM correction writes
    its figure."""
    g = torch.Generator().manual_seed(0)
    t = LJ13()
    x = torch.randn(64, t.dim, generator=g) * 0.5
    d = torch.randn(64, t.dim, generator=g) * 0.5
    path = plot_reweighted_histograms(t, x, t.log_prob(x), d, str(tmp_path), use_com_energy=True,
                                      proposal_com_std=0.1)
    assert os.path.getsize(path) > 0 and path.endswith("reweighted_hist.png")


def test_alp_data_url_loads_a_set_through_the_download(tmp_path):
    """An aldp target with a data_dir that lacks the val set and a file://
    data_url: the set is fetched into data_dir (checksum checked) and
    loaded; the next call reads the copy."""
    frames = np.load(os.path.join(os.path.dirname(__file__), "..",
                                  "aldp_md_T300.npz"))["positions"].reshape(-1, 66)[:50]
    src = tmp_path / "remote"
    src.mkdir()
    np.save(src / "aldp_val.npy", frames.astype(np.float32))
    digest = hashlib.sha256((src / "aldp_val.npy").read_bytes()).hexdigest()
    data_dir = tmp_path / "data"
    t = ALPEnergy("aldp", temperature=300.0, data_dir=str(data_dir),
                  data_url=(src.as_uri() + "/{peptide}_{which}.npy"), data_sha256=digest)
    got = t.setup_val_set("cpu")
    np.testing.assert_array_equal(got, frames.astype(np.float32))
    assert (data_dir / "aldp_temp_300.00_val.npy").exists()


def test_detect_anomaly_raises_on_nan_and_optionally_inf():
    with pytest.raises(FloatingPointError, match="NaN"):
        with detect_anomaly():
            torch.log(torch.tensor([-1.0, 1.0]))
    with detect_anomaly():  # an Inf passes by default
        y = torch.tensor([1.0]) / 0
    assert torch.isinf(y).all()
    with pytest.raises(FloatingPointError, match="Inf"):
        with detect_anomaly(infs=True):
            torch.tensor([1.0]) / 0
    with pytest.raises(RuntimeError):  # a NaN made by a backward pass
        with detect_anomaly(nans=False):
            x = torch.tensor([0.0], requires_grad=True)
            (torch.sqrt(x) * 0).sum().backward()
    with detect_anomaly():  # finite work runs as it is
        assert float(torch.exp(torch.tensor(0.0))) == 1.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        with span("train.step", rung=0):
            torch.randn(64, 64) @ torch.randn(64, 64)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    mm = [e for e in events if "mm" in e.get("name", "") and e.get("ph") == "X"]
    (step,) = [e for e in events if e.get("cat") == "program_span"]
    assert mm and step["name"] == "train.step" and step["args"]["rung"] == 0
    # on the trace's clock: the product lies inside the span
    assert step["ts"] <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= step["ts"] + step["dur"]
