"""The port's peptide evaluation against pita_tpu's on the CPU, on the same
numpy inputs: the distances and MMDs, TICA, the internal-coordinate KLDs,
the chirality centres and corrections, the whole log_on_epoch_end hook; and
a scan of the port's sources for imports of jax, flax, networkx or
pita_tpu."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.metrics import distances as jdist
from pita_tpu.metrics import internal_coords as jic
from pita_tpu.metrics import mmd as jmmd
from pita_tpu.metrics import tica as jtica
from pita_tpu.targets.alp import ALPEnergy as JaxALP
from pita_tpu.utils import chirality as jchir
from pita_torch.metrics import distances as tdist
from pita_torch.metrics import internal_coords as tic
from pita_torch.metrics import mmd as tmmd
from pita_torch.metrics import tica as ttica
from pita_torch.targets.alp import ALPEnergy
from pita_torch.utils import chirality as tchir
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PEPTIDES = ("aldp", "al3", "al4")


def _md(n=200):
    return np.load(REPO / "aldp_md_T300.npz")["positions"].reshape(-1, 66)[:n].astype(np.float32)


def _close(got, want, rtol=1e-4, atol=1e-7):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_point_cloud_distances_match():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((120, 4)).astype(np.float32)
    b = (rng.standard_normal((120, 4)) * 1.3 + 0.2).astype(np.float32)
    ang_a = rng.uniform(-np.pi, np.pi, (100, 2)).astype(np.float32)
    ang_b = np.angle(np.exp(1j * (ang_a + rng.normal(0, 0.7, ang_a.shape)))).astype(np.float32)
    assert tdist.torus_wasserstein(ang_a, ang_b) == jdist.torus_wasserstein(ang_a, ang_b)
    assert tdist.wasserstein1_exact(a, b) == jdist.wasserstein1_exact(a, b)
    assert tdist.wasserstein2_exact(a, b) == jdist.wasserstein2_exact(a, b)
    _close(tdist.compute_distribution_distances(a, b[:100], prefix="p"),
           jdist.compute_distribution_distances(a, b[:100], prefix="p"))
    np.testing.assert_allclose(
        float(tdist.sinkhorn_divergence(torch.as_tensor(a[:50]), torch.as_tensor(b[:60]))),
        float(jdist.sinkhorn_divergence(jnp.asarray(a[:50]), jnp.asarray(b[:60]))), rtol=1e-4)


@pytest.mark.parametrize("which", ["linear", "poly", "mix_rbf"])
def test_mmd_matches(which):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((80, 3)).astype(np.float32)
    y = (rng.standard_normal((90, 3)) * 0.8 + 0.3).astype(np.float32)
    got = getattr(tmmd, f"{which}_mmd2")(torch.as_tensor(x), torch.as_tensor(y))
    want = getattr(jmmd, f"{which}_mmd2")(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-7)


def test_tica_matches():
    data = _md(400)
    gen = data[::-1] + np.float32(0.01)
    got = ttica.run_tica(ALPEnergy("aldp"), data, generated=gen)
    want = jtica.run_tica(JaxALP("aldp"), data, generated=gen)
    for k in ("data_proj", "generated_proj"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["model"].eigenvalues, want["model"].eigenvalues, rtol=1e-5)
    with pytest.raises(AssertionError):
        ttica.run_tica(ALPEnergy("aldp"), data[:8])


@pytest.mark.parametrize("peptide", PEPTIDES)
def test_internal_coords_match(peptide):
    t, j = ALPEnergy(peptide), JaxALP(peptide)
    x0 = t.initial_structure()
    rng = np.random.default_rng(2)
    data = (x0[None] + 0.01 * rng.standard_normal((600, x0.size))).astype(np.float32)
    gen = (x0[None] + 0.013 * rng.standard_normal((500, x0.size))).astype(np.float32)
    _close(tic.evaluate_internal_coords(t, gen, data, prefix="val/ic"),
           jic.evaluate_internal_coords(j, gen, data, prefix="val/ic"), rtol=1e-6, atol=1e-9)
    assert tic.evaluate_internal_coords(t, gen[:0], data) == {}


@pytest.mark.parametrize("peptide", PEPTIDES)
def test_chirality_centers_and_fixes_match(peptide):
    t = ALPEnergy(peptide)
    elements = [n[0] for n in t.topology["names"]]
    bonds = t.topology["bonds"]
    centers = tchir.find_chirality_centers(bonds, elements)
    assert centers == jchir.find_chirality_centers(bonds, elements)
    assert len(centers) == _n_ca(t)  # one centre per alanine CA
    x0 = t.initial_structure().reshape(-1, 3)
    assert tchir.bonds_from_distances(x0, elements) == jchir.bonds_from_distances(x0, elements)
    rng = np.random.default_rng(3)
    x = x0[None] + 0.01 * rng.standard_normal((300, *x0.shape))
    x[::3, :, 2] *= -1  # every third sample mirrored
    x[1::7, :, 0] *= -1
    ref = [tchir.chirality_sign(x0[None], c, nbrs)[0] for c, nbrs in centers]
    got, want = (m.check_and_fix_chirality(x, centers, ref) for m in (tchir, jchir))
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    assert got[1].any() and not got[1].all()


def _n_ca(t):
    return sum(n == "CA" for n in t.topology["names"])


def _hook_inputs(n=300):
    """Data: MD frames; samples: the frames shuffled and perturbed, some
    mirrored (the chirality correction then has work to do)."""
    data = _md(n)
    rng = np.random.default_rng(4)
    samples = data[rng.permutation(n)] + (0.02 * rng.standard_normal(data.shape)).astype(np.float32)
    s = samples.reshape(n, -1, 3)
    s[::5, :, 2] *= -1
    nores = data[rng.permutation(n)][:200] + np.float32(0.005)
    return data, samples.reshape(n, -1), nores


def test_log_on_epoch_end_matches():
    data, samples, nores = _hook_inputs()
    kw = dict(prefix="val", samples_not_resampled=nores)
    got = ALPEnergy("aldp", temperature=300.0).log_on_epoch_end(
        torch.as_tensor(samples), torch.as_tensor(data), **kw)
    want = JaxALP("aldp", temperature=300.0).log_on_epoch_end(
        jnp.asarray(samples), jnp.asarray(data), **kw)
    for k in ("val/rama/resampled/torus_wasserstein", "val/rama/not_resampled/w2",
              "val/correct_symmetry_rate", "val/uncorrectable_symmetry_rate", "val/tica/w1",
              "val/ic/kld_mean"):
        assert k in want, k
    _close(got, want)


def test_log_on_epoch_end_skips_tica_on_a_short_set(capsys):
    data, samples, _ = _hook_inputs(9)
    got = ALPEnergy("aldp").log_on_epoch_end(samples, data)
    assert "TICA skipped" in capsys.readouterr().out
    assert not any(k.startswith("val/tica") for k in got)
    assert "val/rama/resampled/w1" in got


BANNED = ("jax", "jaxlib", "flax", "networkx", "pita_tpu", "msgpack")


def test_port_sources_import_no_jax_flax_networkx_or_pita_tpu():
    """Every import statement in pita_torch/ and chip_smoke.py, at any
    depth (imports inside functions too)."""
    files = sorted((REPO / "pita_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(f.name == "chirality.py" for f in files)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in BANNED, f"{f.relative_to(REPO)} imports {m}"
