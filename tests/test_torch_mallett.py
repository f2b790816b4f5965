"""The port's Mallett 2019 upsampler and colorimetry against the JAX
package and the table on the CPU: the basis on several grids, the cube
and the fused band matrix (1e-6), the colorimetry functions, the port's
own copy of the table (byte-equal to the JAX package's), the "published"
source (absent: FileNotFoundError), and the defining properties of
``tests/test_mallett.py`` run on the port."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.spectral import classic as jclassic
from animal_vision_tpu.spectral import colorimetry as jcolorimetry
from animal_vision_tpu_torch.spectral import classic, colorimetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = "mallett2019_basis_5nm.npz"
GRIDS = [
    np.linspace(400.0, 700.0, 31),
    np.linspace(380.0, 780.0, 81),
    np.linspace(300.0, 700.0, 81, dtype=np.float32),
    np.linspace(320.0, 700.0, 129),
    np.linspace(350.0, 820.0, 48),
]


def test_table_is_the_port_own_copy():
    port = os.path.join(REPO, "animal_vision_tpu_torch", "spectral", "data", TABLE)
    with open(port, "rb") as a, open(os.path.join(REPO, "animal_vision_tpu", "spectral", "data", TABLE), "rb") as b:
        assert a.read() == b.read()
    assert str(classic.DATA / TABLE) == port
    wl, basis = classic._mallett_table()
    wl_j, basis_j = jclassic._mallett_table()
    np.testing.assert_array_equal(wl, wl_j)
    np.testing.assert_array_equal(basis, basis_j)


def test_published_source_raises():
    with pytest.raises(FileNotFoundError):
        classic._mallett_table(source="published")


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_basis_matrix_vs_jax(grid):
    key = tuple(float(v) for v in GRIDS[grid])
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(classic.mallett_basis_matrix(key, dtype), jclassic.mallett_basis_matrix(key, dtype))


@pytest.mark.parametrize("linearize", [True, False])
@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_cube_and_fused_matrix_vs_jax(grid, linearize):
    wl = GRIDS[grid]
    rng = np.random.default_rng(grid)
    x = rng.uniform(0, 1, (2, 11, 13, 3)).astype(np.float32)
    got = classic.classic_rgb_to_hsi(torch.from_numpy(x), wl, linearize=linearize, mode="mallett").numpy()
    for i in range(2):
        want = np.asarray(jclassic.classic_rgb_to_hsi(jnp.asarray(x[i]), wl, linearize=linearize, mode="mallett"))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)
    w = rng.uniform(0, 1, (wl.size, 3))
    np.testing.assert_allclose(classic.fused_band_matrix(wl, w, mode="mallett"),
                               jclassic.fused_band_matrix(wl, w, mode="mallett"), rtol=0, atol=1e-6)
    np.testing.assert_allclose(classic.fused_band_matrix(wl, w[:, 0], mode="mallett"),
                               jclassic.fused_band_matrix(wl, w[:, 0], mode="mallett"), rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_colorimetry_vs_jax(grid):
    wl = GRIDS[grid]
    for name in ("cie_xyz_cmf", "d65_spd", "spectrum_to_xyz_operator"):
        np.testing.assert_array_equal(getattr(colorimetry, name)(wl), getattr(jcolorimetry, name)(wl))
    for got, want in zip(colorimetry.srgb_matrices(wl), jcolorimetry.srgb_matrices(wl)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(colorimetry.SRGB_PRIMARIES, jcolorimetry.SRGB_PRIMARIES)


def test_basis_partition_of_unity_and_nonneg():
    wl, basis = classic._mallett_table()
    assert basis.shape == (3, 81) and wl[0] == 380.0 and wl[-1] == 780.0
    np.testing.assert_allclose(basis.sum(axis=0), 1.0, atol=1e-9)
    assert basis.min() >= 0.0


def test_basis_projects_to_identity():
    wl, basis = classic._mallett_table()
    _, t_rgb = colorimetry.srgb_matrices(wl)
    np.testing.assert_allclose(t_rgb @ basis.T, np.eye(3), atol=1e-7)


def test_rgb_round_trip_through_spectrum():
    wl, _ = classic._mallett_table()
    _, t_rgb = colorimetry.srgb_matrices(wl)
    rgb = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    cube = classic.classic_rgb_to_hsi(torch.from_numpy(rgb), wl, linearize=False, mode="mallett").numpy()
    back = cube.reshape(-1, wl.size) @ t_rgb.T
    np.testing.assert_allclose(back.reshape(rgb.shape), rgb, atol=1e-5)


def test_white_recovers_flat_spectrum():
    wl, _ = classic._mallett_table()
    cube = classic.classic_rgb_to_hsi(torch.ones((1, 1, 3)), wl, linearize=False, mode="mallett").numpy()
    np.testing.assert_allclose(cube, 1.0, atol=1e-6)


def test_interpolation_consistency():
    rgb = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (3, 4, 3)).astype(np.float32))
    c31 = classic.classic_rgb_to_hsi(rgb, np.linspace(400.0, 700.0, 31), mode="mallett").numpy()
    c81 = classic.classic_rgb_to_hsi(rgb, np.linspace(380.0, 780.0, 81), mode="mallett").numpy()
    np.testing.assert_allclose(c31, c81[..., 4:65:2], atol=1e-7)


def test_fixture_regression():
    """The stored 4x4x31 cube of the JAX package's test, on the port."""
    rgb = np.random.default_rng(42).uniform(0, 1, (4, 4, 3)).astype(np.float32)
    cube = classic.classic_rgb_to_hsi(torch.from_numpy(rgb), mode="mallett").numpy()
    want = np.load(os.path.join(REPO, "tests", "fixtures", "mallett_cube_4x4x31.npy"))
    np.testing.assert_allclose(cube, want, atol=1e-6)


def test_invalid_mode_raises():
    with pytest.raises(ValueError):
        classic.classic_rgb_to_hsi(torch.ones((1, 1, 3)), mode="nope")
    with pytest.raises(ValueError):
        classic.fused_band_matrix(np.linspace(400.0, 700.0, 31), np.ones(31), mode="nope")
