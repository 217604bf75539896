"""The port's alanine-peptide target against pita_tpu's on the CPU: the
topologies and force-field arrays exactly, energies and forces (with and
without the solvent) on the minimized structures and on MD frames, the
dihedrals, the embed and the initial structure, the cached data sets, the
committed MD energies, and the refused download."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.targets import alp as jalp
from pita_torch.targets import alp as talp
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PEPTIDES = ("aldp", "al3", "al4")


def _frames(peptide, n=64, seed=0):
    """n configurations [nm]: the minimized structure with 1e-3 nm noise."""
    x0 = np.load(REPO / "pita_tpu" / "assets" / f"{peptide}_minimized.npy")
    rng = np.random.default_rng(seed)
    return (x0[None] + 1e-3 * rng.standard_normal((n, x0.size))).astype(np.float32)


def _md_frames(n=64):
    return np.load(REPO / "aldp_md_T300.npz")["positions"].reshape(-1, 66)[:n].astype(np.float32)


@pytest.mark.parametrize("peptide", PEPTIDES)
def test_topology_and_forcefield_params_equal_pita_tpu(peptide):
    n_ala = talp.PEPTIDES[peptide]
    jt, tt = jalp.build_peptide_topology(n_ala), talp.build_peptide_topology(n_ala)
    assert jt.keys() == tt.keys()
    for k in jt:
        assert np.array_equal(np.asarray(jt[k]), np.asarray(tt[k])), k
    jp, tp = jalp.build_forcefield_params(jt), talp.build_forcefield_params(tt)
    assert jp._fields == tp._fields
    for f, a, b in zip(jp._fields, jp, tp):
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert np.array_equal(a, b), f
    assert talp._MASS == jalp._MASS and talp.NM_TO_ANGSTROM == jalp.NM_TO_ANGSTROM
    assert talp.PEPTIDES == jalp.PEPTIDES


def _energy_and_force_gap(peptide, x, solvent):
    jt = jalp.ALPEnergy(peptide, temperature=300.0, implicit_solvent=solvent)
    tt = talp.ALPEnergy(peptide, temperature=300.0, implicit_solvent=solvent)
    ej = np.asarray(jax.jit(jt.energy_kcal)(jnp.asarray(x)))
    et = tt.energy_kcal(torch.as_tensor(x)).numpy()
    lj, fj = (np.asarray(a) for a in jax.jit(jt.log_prob_and_force)(jnp.asarray(x)))
    lt, ft = (a.numpy() for a in tt.log_prob_and_force(torch.as_tensor(x)))
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    return rel(et, ej), rel(lt, lj), rel(ft, fj)


@pytest.mark.parametrize("solvent", [True, False], ids=["obc", "vacuum"])
@pytest.mark.parametrize("peptide", PEPTIDES)
def test_energy_and_force_match_pita_tpu(peptide, solvent):
    """Energy, log-prob and force (autograd against jax.grad) within 1e-5 of
    the largest value, on the minimized structure under 1e-3 nm noise."""
    gaps = _energy_and_force_gap(peptide, _frames(peptide), solvent)
    assert max(gaps) <= 1e-5, gaps


@pytest.mark.parametrize("solvent", [True, False], ids=["obc", "vacuum"])
def test_energy_and_force_match_on_md_frames(solvent):
    gaps = _energy_and_force_gap("aldp", _md_frames(), solvent)
    assert max(gaps) <= 1e-5, gaps


def test_committed_md_energies():
    """The 800 frames of aldp_md_T300.npz against their committed energies:
    within 5e-3 kcal/mol (pita_tpu reads 1.45e-3)."""
    z = np.load(REPO / "aldp_md_T300.npz")
    e = talp.ALPEnergy("aldp").energy_kcal(
        torch.as_tensor(z["positions"].reshape(-1, 66), dtype=torch.float32)).numpy()
    assert np.abs(e - z["energies"].reshape(-1)).max() <= 5e-3


@pytest.mark.parametrize("peptide", PEPTIDES)
def test_dihedrals_match_pita_tpu(peptide):
    x = np.concatenate([_frames(peptide, 32), _frames(peptide, 32, seed=1) * 1.02])
    if peptide == "aldp":
        x = np.concatenate([x, _md_frames()])
    jphi, jpsi = jalp.ALPEnergy(peptide).dihedrals(jnp.asarray(x))
    tphi, tpsi = talp.ALPEnergy(peptide).dihedrals(torch.as_tensor(x))
    for a, b in ((tphi, jphi), (tpsi, jpsi)):
        d = np.abs(a.numpy() - np.asarray(b))
        assert np.minimum(d, 2 * np.pi - d).max() <= 1e-6


@pytest.mark.parametrize("peptide", PEPTIDES + ("al5",))
def test_rough_embed_and_initial_structure_equal(peptide):
    n_ala = talp.PEPTIDES[peptide]
    top = talp.build_peptide_topology(n_ala)
    assert np.array_equal(talp._rough_embed(top), jalp._rough_embed(top))
    if peptide != "al5":  # al5 has no asset: its structure is minimized
        assert np.array_equal(talp.ALPEnergy(peptide).initial_structure(),
                              jalp.ALPEnergy(peptide).initial_structure())


def test_minimize_follows_pita_tpu():
    """A few Adam steps of the minimizer from the rough embed of al5 (which
    has no asset): the same path within 1e-5 nm."""
    top = talp.build_peptide_topology(talp.PEPTIDES["al5"])
    x0 = talp._rough_embed(top)
    a = talp._minimize(talp.ALPEnergy("al5"), x0, steps=20)
    b = jalp._minimize(jalp.ALPEnergy("al5"), x0, steps=20)
    assert np.abs(a - b).max() <= 1e-5


def test_cached_data_dir_set_loads_identically(tmp_path):
    data = _md_frames(100)
    for which in ("train", "val", "test"):
        np.save(tmp_path / f"aldp_temp_755.95_{which}.npy", data[::-1] if which == "val" else data)
    jt = jalp.ALPEnergy("aldp", temperature=755.95, data_dir=str(tmp_path))
    tt = talp.ALPEnergy("aldp", temperature=755.95, data_dir=str(tmp_path))
    for which in ("train", "val", "test"):
        a = getattr(tt, f"setup_{which}_set")("cpu")
        b = getattr(jt, f"setup_{which}_set")()
        assert a.dtype == np.float32 and np.array_equal(a, b), which
    g = torch.Generator().manual_seed(0)
    rows = tt.sample_val_set(10, g).numpy()
    assert all(any(np.array_equal(r, d) for d in data) for r in rows)


def test_data_url_raises(tmp_path):
    """With a data_url and no set on disk, a failed download raises the
    datamodule's error when the set is first needed, as pita_tpu's target
    does (alp.py:426-433); the URL is a closed port on this host."""
    t = talp.ALPEnergy("aldp", data_dir=str(tmp_path),
                       data_url="http://127.0.0.1:1/{peptide}_{which}.npy")
    with pytest.raises(RuntimeError, match="download failed"):
        t.setup_val_set("cpu")


def test_at_temperature_keeps_the_params_and_scales_log_prob():
    t = talp.ALPEnergy("aldp", temperature=300.0)
    u = t.at_temperature(600.0)
    x = torch.as_tensor(_frames("aldp", 4))
    torch.testing.assert_close(u.log_prob(x) * 2, t.log_prob(x), rtol=1e-6, atol=0)
    assert u.params is t.params and u.temperature == 600.0
