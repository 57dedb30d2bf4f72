"""Lattice-data unit tests (SURVEY.md §4.2 item 1)."""

import numpy as np
import pytest

from bravais_tpu.lattices import (LATTICE_NAMES, LATTICE_NAMES_2D, kpath,
                                  make_lattice)

ALL_NAMES = LATTICE_NAMES + LATTICE_NAMES_2D

# Parameter sets that exercise every S&C variant.
VARIANT_CASES = [
    ("CUB", {}), ("FCC", {}), ("BCC", {}), ("TET", {}),
    ("BCT", {"c": 0.8}), ("BCT", {"c": 1.3}),
    ("ORC", {}),
    ("ORCF", {"a": 0.6, "b": 1.2, "c": 1.4}),   # 1/a^2 > 1/b^2+1/c^2 -> ORCF1
    ("ORCF", {"a": 1.1, "b": 1.2, "c": 1.4}),   # ORCF2
    ("ORCI", {}), ("ORCC", {}), ("HEX", {}),
    ("RHL", {"alpha": np.deg2rad(60)}), ("RHL", {"alpha": np.deg2rad(110)}),
    ("MCL", {}),
    ("MCLC", {}),                                              # MCLC1
    ("MCLC", {"a": 1.5, "b": 0.9, "c": 1.3,
              "alpha": np.deg2rad(80.0)}),                     # MCLC3
    ("MCLC", {"a": 1.1113168354882346, "b": 1.0, "c": 1.2,
              "alpha": np.deg2rad(70.0)}),                     # MCLC4
    ("MCLC", {"a": 1.05, "b": 1.0, "c": 1.05,
              "alpha": np.deg2rad(30.0)}),                     # MCLC5
    ("TRI", {"alpha": np.deg2rad(65), "beta": np.deg2rad(70),
             "gamma": np.deg2rad(75)}),
    ("TRI", {"alpha": np.deg2rad(105), "beta": np.deg2rad(110),
             "gamma": np.deg2rad(115)}),
    ("SQR", {}), ("RECT", {}), ("CRECT", {}), ("HEX2D", {}), ("OBL", {}),
]


@pytest.mark.parametrize("name,kw", VARIANT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(VARIANT_CASES)])
def test_reciprocal_duality(name, kw):
    lat = make_lattice(name, **kw)
    # b_i . a_j = 2 pi delta_ij  (SURVEY.md §4.2)
    np.testing.assert_allclose(lat.B @ lat.A.T, 2 * np.pi * np.eye(lat.dim),
                               atol=1e-12)
    assert lat.cell_volume > 0


@pytest.mark.parametrize("name,kw", VARIANT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(VARIANT_CASES)])
def test_path_points_defined(name, kw):
    lat = make_lattice(name, **kw)
    for sub in lat.path:
        assert len(sub) >= 2
        for lab in sub:
            assert lab in lat.points
    # Gamma is always present and at the origin.
    np.testing.assert_allclose(lat.points["G"], 0.0, atol=0)


def test_sc_point_tables():
    """Spot-check S&C fractional coordinates (SURVEY.md App. A tables)."""
    fcc = make_lattice("FCC")
    np.testing.assert_allclose(fcc.points["X"], [0.5, 0, 0.5])
    np.testing.assert_allclose(fcc.points["W"], [0.5, 0.25, 0.75])
    np.testing.assert_allclose(fcc.points["K"], [0.375, 0.375, 0.75])
    np.testing.assert_allclose(fcc.points["L"], [0.5, 0.5, 0.5])
    cub = make_lattice("CUB")
    np.testing.assert_allclose(cub.points["R"], [0.5, 0.5, 0.5])
    bcc = make_lattice("BCC")
    np.testing.assert_allclose(bcc.points["P"], [0.25, 0.25, 0.25])
    sq = make_lattice("SQR")
    np.testing.assert_allclose(sq.points["M"], [0.5, 0.5])


def test_cartesian_symmetry_points_cubic():
    """For CUB with lattice constant a, X = (0, pi/a, 0) etc."""
    a = 2.0
    lat = make_lattice("CUB", a=a)
    np.testing.assert_allclose(lat.point_cart("X"), [0, np.pi / a, 0],
                               atol=1e-12)
    np.testing.assert_allclose(lat.point_cart("R"),
                               [np.pi / a, np.pi / a, np.pi / a], atol=1e-12)
    # FCC: X should be (2pi/a)(0,1,0)-type point, |X| = 2 pi / a.
    fcc = make_lattice("FCC", a=a)
    assert np.isclose(np.linalg.norm(fcc.point_cart("X")), 2 * np.pi / a)
    # L = (pi/a)(1,1,1)
    np.testing.assert_allclose(np.abs(fcc.point_cart("L")),
                               np.pi / a * np.ones(3), atol=1e-12)


def test_variant_dispatch():
    assert make_lattice("BCT", c=0.8).variant == "BCT1"
    assert make_lattice("BCT", c=1.3).variant == "BCT2"
    assert make_lattice("ORCF", a=0.6, b=1.2, c=1.4).variant == "ORCF1"
    assert make_lattice("ORCF", a=1.1, b=1.2, c=1.4).variant == "ORCF2"
    assert make_lattice("RHL", alpha=np.deg2rad(60)).variant == "RHL1"
    assert make_lattice("RHL", alpha=np.deg2rad(110)).variant == "RHL2"
    # Obtuse direct angles -> acute reciprocal angles -> TRI1b branch.
    assert make_lattice("TRI", alpha=np.deg2rad(105), beta=np.deg2rad(110),
                        gamma=np.deg2rad(115)).variant in ("TRI1b", "TRI2b")
    assert make_lattice("MCLC").variant.startswith("MCLC")


def test_aliases():
    assert make_lattice("simple_cubic").name == "CUB"
    assert make_lattice("square").name == "SQR"
    with pytest.raises(ValueError):
        make_lattice("nope")


@pytest.mark.parametrize("name,kw", VARIANT_CASES[:8])
def test_kpath_sampling(name, kw):
    lat = make_lattice(name, **kw)
    kp = kpath(lat, npts=60)
    assert kp.nk >= 60
    # Distances are monotone non-decreasing and continuous within segments.
    assert np.all(np.diff(kp.dist) >= -1e-14)
    # Each tick label sits on the matching symmetry point (possibly merged).
    for idx, lab in kp.labels:
        lab0 = lab.split("|")[0]
        np.testing.assert_allclose(
            kp.k_cart[idx], lat.point_cart(lab0), atol=1e-12)
    # k_frac and k_cart agree through the reciprocal basis.
    np.testing.assert_allclose(kp.k_frac @ lat.B, kp.k_cart, atol=1e-12)


def test_kpath_custom_headline():
    """The headline FCC Γ–X–W–L path (BASELINE.json:5)."""
    lat = make_lattice("FCC")
    kp = kpath(lat, npts=32, path=[["G", "X", "W", "L"]])
    labs = [lab for _, lab in kp.labels]
    assert labs == ["G", "X", "W", "L"]
    np.testing.assert_allclose(kp.k_cart[0], 0.0, atol=0)


def test_kpath_segment_structure():
    lat = make_lattice("CUB")
    kp = kpath(lat, npts=50)
    assert len(kp.segments) == len(lat.path)
    total = sum(b - a for a, b in kp.segments)
    assert total == kp.nk


# ---------------------------------------------------------------------------
# S&C variant coverage: every dispatch branch instantiated + validated
#.
# ---------------------------------------------------------------------------

def _bz_boundary_ok(lat, labels=None, tol=1e-7):
    """Every non-Γ point lies ON the first-BZ boundary (Voronoi
    property |k| = min_G |k−G|, minimum attained off-origin)."""
    import itertools
    Gs = np.array([m for m in itertools.product(range(-2, 3),
                                                repeat=lat.dim)
                   if any(m)], np.float64) @ lat.B
    labels = labels or [x for seg in lat.path for x in seg]
    for lab in set(labels):
        k = lat.point_cart(lab)
        r = np.linalg.norm(k)
        if r < tol:
            continue
        dmin = np.min(np.linalg.norm(k - Gs[None], axis=-1))
        assert abs(r - dmin) < tol * max(r, 1.0), (lat.variant, lab, r,
                                                   dmin)


def test_every_sc_variant_instantiable():
    """One parameter set per S&C variant; each must dispatch to its
    branch, satisfy reciprocal duality, and have all path points on
    the BZ boundary (the strong self-check for parameter-dependent
    fraction formulas — a wrong fraction generically lands strictly
    inside/outside the BZ)."""
    import scipy.optimize

    cases = {
        "BCT1": ("BCT", dict(c=0.8)),
        "BCT2": ("BCT", dict(c=1.3)),
        "ORCF1": ("ORCF", dict(a=0.6, b=1.2, c=1.4)),
        "ORCF2": ("ORCF", dict(a=1.1, b=1.2, c=1.4)),
        "ORCF3": ("ORCF", dict(a=1.0 / np.sqrt(1 / 1.2 ** 2
                                               + 1 / 1.4 ** 2),
                               b=1.2, c=1.4)),
        "RHL1": ("RHL", dict(alpha=np.deg2rad(60))),
        "RHL2": ("RHL", dict(alpha=np.deg2rad(110))),
        "MCLC1": ("MCLC", dict()),
        "MCLC3": ("MCLC", dict(a=1.5, b=0.9, c=1.3,
                               alpha=np.deg2rad(80.0))),
        "MCLC4": ("MCLC", dict(a=1.1113168354882346, b=1.0, c=1.2,
                               alpha=np.deg2rad(70.0))),
        "MCLC5": ("MCLC", dict(a=1.05, b=1.0, c=1.05,
                               alpha=np.deg2rad(30.0))),
        "TRI1a": ("TRI", dict(alpha=np.deg2rad(65),
                              beta=np.deg2rad(70),
                              gamma=np.deg2rad(75))),
        "TRI1b": ("TRI", dict(alpha=np.deg2rad(105),
                              beta=np.deg2rad(110),
                              gamma=np.deg2rad(115))),
    }
    # MCLC2: reciprocal kγ = 90° exactly — solve for a.
    def _kga_dot(a):
        lat = make_lattice("MCLC", a=a, b=1.1, c=1.3,
                           alpha=np.deg2rad(75.0))
        return lat.B[0] @ lat.B[1]
    a2 = scipy.optimize.brentq(_kga_dot, 0.8, 1.5, xtol=1e-14)
    cases["MCLC2"] = ("MCLC", dict(a=a2, b=1.1, c=1.3,
                                   alpha=np.deg2rad(75.0)))

    # TRI2a / TRI2b: kγ = 90° exactly with obtuse / acute kα, kβ.
    def _tri_kga_dot(g, al, be):
        lat = make_lattice("TRI", alpha=np.deg2rad(al),
                           beta=np.deg2rad(be), gamma=np.deg2rad(g))
        return lat.B[0] @ lat.B[1]
    g2a = scipy.optimize.brentq(lambda g: _tri_kga_dot(g, 65, 70),
                                60, 120, xtol=1e-13)
    cases["TRI2a"] = ("TRI", dict(alpha=np.deg2rad(65),
                                  beta=np.deg2rad(70),
                                  gamma=np.deg2rad(g2a)))
    g2b = scipy.optimize.brentq(lambda g: _tri_kga_dot(g, 105, 110),
                                60, 130, xtol=1e-13)
    cases["TRI2b"] = ("TRI", dict(alpha=np.deg2rad(105),
                                  beta=np.deg2rad(110),
                                  gamma=np.deg2rad(g2b)))

    for variant, (family, kw) in cases.items():
        lat = make_lattice(family, **kw)
        assert lat.variant == variant, (variant, lat.variant, kw)
        assert not lat.generic_path, variant
        np.testing.assert_allclose(lat.B @ lat.A.T,
                                   2 * np.pi * np.eye(3), atol=1e-10)
        # TRI is exempt from the Voronoi gate: S&C deliberately places
        # the triclinic points on reciprocal-CELL faces (half-integer
        # fractions), which for general angles are not first-BZ
        # boundary points (the TRI BZ is an arbitrary polyhedron).
        if not variant.startswith("TRI"):
            _bz_boundary_ok(lat)
        kp = kpath(lat, npts=40)          # path samples without error
        assert np.all(np.diff(kp.dist) >= -1e-14)


def test_mclc_tables_parameter_scan():
    """The MCLC fraction formulas stay BZ-valid over parameter scans
    within each variant's regime (not just at one point)."""
    scans = [
        dict(a=1.0, b=1.1, c=1.3, alpha=np.deg2rad(75.0)),    # MCLC1
        dict(a=0.7, b=1.1, c=1.2, alpha=np.deg2rad(65.0)),    # MCLC1
        dict(a=1.5, b=0.9, c=1.3, alpha=np.deg2rad(80.0)),    # MCLC3
        dict(a=2.5, b=1.0, c=1.1, alpha=np.deg2rad(70.0)),    # MCLC3
        dict(a=3.0, b=1.2, c=1.25, alpha=np.deg2rad(60.0)),   # MCLC3
        dict(a=1.1, b=1.0, c=1.1, alpha=np.deg2rad(40.0)),    # MCLC5
        dict(a=1.3, b=1.2, c=1.25, alpha=np.deg2rad(45.0)),   # MCLC5
        dict(a=1.02, b=0.95, c=1.0, alpha=np.deg2rad(35.0)),  # MCLC5
    ]
    for kw in scans:
        lat = make_lattice("MCLC", **kw)
        assert not lat.generic_path, (lat.variant, kw)
        _bz_boundary_ok(lat)


def _shell_spectrum(A, R=2.3456):
    """Sorted lattice-point norms below R (basis-aware sampling bound
    so highly skewed bases are fully enumerated). Congruent lattices
    have identical spectra; R is chosen off typical shell radii and the
    comparison truncates to the shorter list to dodge cutoff ties."""
    import itertools
    A = np.asarray(A, np.float64)
    Ainv = np.linalg.inv(A)
    rngs = [int(np.ceil(R * np.linalg.norm(Ainv[:, i]))) + 1
            for i in range(A.shape[0])]
    pts = np.array(list(itertools.product(
        *[range(-r, r + 1) for r in rngs])), np.float64) @ A
    n = np.sort(np.linalg.norm(pts, axis=1))
    return n[n < R]


def _assert_congruent(A1, A2):
    s1, s2 = _shell_spectrum(A1), _shell_spectrum(A2)
    m = min(len(s1), len(s2))
    assert m > 10
    assert abs(len(s1) - len(s2)) <= 2          # cutoff-shell ties only
    np.testing.assert_allclose(s1[:m], s2[:m], atol=1e-9)
    assert np.isclose(abs(np.linalg.det(A1)), abs(np.linalg.det(A2)))


@pytest.mark.parametrize("kw", [
    dict(a=0.5, b=1.0, c=1.05, alpha=np.deg2rad(55.0)),   # r3 fallback case
    dict(a=1.0, b=0.8, c=2.0, alpha=np.deg2rad(20.0)),    # strong c-skew
    dict(a=1.0, b=1.1, c=1.3, alpha=np.deg2rad(105.0)),   # obtuse alpha
    dict(a=2.0, b=1.0, c=4.0, alpha=np.deg2rad(150.0)),   # both
    dict(a=0.6, b=1.3, c=5.0, alpha=np.deg2rad(10.0)),    # extreme skew
])
def test_mclc_cell_normalization(kw):
    """Out-of-convention MCLC cells (obtuse α, c·cosα > b/2) are
    reduced into the S&C regime by lattice-preserving moves, so the
    encoded point tables apply instead of the generic-path fallback
    (round-4 gap closure). The normalized cell must generate a lattice
    congruent to the naive one."""
    lat = make_lattice("MCLC", **kw)
    assert not lat.generic_path, (lat.variant, kw)
    _bz_boundary_ok(lat)
    a, b, c, al = kw["a"], kw["b"], kw["c"], kw["alpha"]
    A_naive = np.array([[a / 2, b / 2, 0], [-a / 2, b / 2, 0],
                        [0, c * np.cos(al), c * np.sin(al)]])
    _assert_congruent(A_naive, lat.A)
    # and the normalized parameters really are conventional
    p = lat.params
    assert p["alpha"] <= np.pi / 2 + 1e-12
    assert p["c"] * np.cos(p["alpha"]) <= p["b"] / 2 + 1e-9
    # params round-trip: rebuilding from the reported conventional cell
    # reproduces the identical basis (normalization is idempotent)
    lat2 = make_lattice("MCLC", **{k: p[k] for k in "abc"},
                        alpha=p["alpha"])
    np.testing.assert_allclose(lat2.A, lat.A, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(b=1.5, c=1.1, alpha=np.deg2rad(75.0)),    # b > c
    dict(b=1.1, c=1.3, alpha=np.deg2rad(110.0)),   # obtuse (was silently
    dict(b=0.8, c=3.0, alpha=np.deg2rad(15.0)),    # off-BZ before r4 —
    dict(b=2.5, c=0.7, alpha=np.deg2rad(160.0)),   # MCL had no guard)
])
def test_mcl_cell_normalization(kw):
    """MCL cells outside the S&C convention (b > c, obtuse α, strong
    skew) are Gauss-reduced into it; previously these silently emitted
    off-BZ 'symmetry' points (MCL had no _path_on_bz guard)."""
    lat = make_lattice("MCL", **kw)
    assert not lat.generic_path
    _bz_boundary_ok(lat)
    b, c, al = kw["b"], kw["c"], kw["alpha"]
    A_naive = np.array([[1.0, 0, 0], [0, b, 0],
                        [0, c * np.cos(al), c * np.sin(al)]])
    _assert_congruent(A_naive, lat.A)
    p = lat.params
    assert p["b"] <= p["c"] + 1e-12 and p["alpha"] <= np.pi / 2 + 1e-12
