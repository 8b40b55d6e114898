"""Predicate parity between the JAX package and the PyTorch port.

The same numpy-built predicates and scalars go through ``eval_mask``,
``soft_encode``, ``value_encode``, the histograms' ``estimate_selectivity``
and the builder algebra's ``compile`` of both packages, including the edge
cases: values on interior bin edges (``side="right"``), ±inf range bounds,
and ``nextafter`` strict bounds.
Masks, compiled fields and one-hot codes must be equal; float encodings and
selectivities agree to 1e-6 (float32 rounding of the same formulas).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.vectordb import algebra as jal  # noqa: E402
from repro.vectordb import histogram as jh  # noqa: E402
from repro.vectordb import predicates as jp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.vectordb import algebra as tal  # noqa: E402
from repro_torch.vectordb import histogram as th  # noqa: E402
from repro_torch.vectordb import predicates as tp  # noqa: E402

TOL = 1e-6


@pytest.fixture(scope="module")
def scal4():
    rng = np.random.default_rng(7)
    return np.stack([
        rng.integers(0, 10, 3000).astype(np.float32),
        rng.integers(0, 50, 3000).astype(np.float32),
        rng.lognormal(1.0, 0.6, 3000).astype(np.float32),
        rng.uniform(1.0, 1000.0, 3000).astype(np.float32)], axis=1)


def random_expr(col, rng, scal, depth=0):
    """Random builder tree over the data's value ranges, written against
    either package's ``col`` (the same rng draws give the same tree)."""
    m = scal.shape[1]
    r = rng.random()
    if depth >= 3 or r < 0.45:
        c = int(rng.integers(0, m))
        lo, hi = float(scal[:, c].min()), float(scal[:, c].max())
        a, b = sorted(rng.uniform(lo, hi, 2))
        kind = rng.integers(0, 7)
        if kind == 0:
            return col(c).between(a, b)
        if kind == 1:
            return col(c) <= b
        if kind == 2:
            return col(c) > a
        if kind == 3:
            return col(c) == float(rng.choice(scal[:, c]))
        if kind == 4:
            return col(c).below(b)
        if kind == 5:
            return col(c) != float(rng.choice(scal[:, c]))
        vals = rng.choice(np.unique(scal[:, c]),
                          size=min(3, len(np.unique(scal[:, c]))),
                          replace=False)
        return col(c).isin([float(v) for v in vals])
    a = random_expr(col, rng, scal, depth + 1)
    b = random_expr(col, rng, scal, depth + 1)
    if r < 0.7:
        return a & b
    if r < 0.9:
        return a | b
    return ~a


def compile_both(seed, scal):
    """-> (jax PredicateSet, port PredicateSet) or None when the DNF is
    wider than the clause grid (both must refuse alike)."""
    m = scal.shape[1]
    ej = random_expr(jal.col, np.random.default_rng(seed), scal)
    et = random_expr(tal.col, np.random.default_rng(seed), scal)
    try:
        pj = ej.compile(m=m)
    except ValueError:
        with pytest.raises(ValueError):
            et.compile(m=m, device="cpu")
        return None
    return pj, et.compile(m=m, device="cpu")


def fields(p):
    return [np.asarray(getattr(p, f)) for f in ("active", "lo", "hi",
                                                "clause_valid")]


def test_algebra_compile_and_eval_mask_match_jax(scal4):
    """120 random trees: identical compiled fields (strict bounds via
    nextafter included) and identical masks on the data."""
    compiled = 0
    for seed in range(120):
        pair = compile_both(seed, scal4)
        if pair is None:
            continue
        pj, pt = pair
        for a, b in zip(fields(pj), fields(pt)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            np.asarray(jp.eval_mask(pj, jnp.asarray(scal4))),
            tp.eval_mask(pt, torch.as_tensor(scal4)).numpy())
        compiled += 1
    assert compiled > 60


def test_strict_bounds_and_names_compile_alike(tiny_table):
    schema = tiny_table.schema
    for build in (lambda c: c("price").below(100.0) | (c("brand") != 3),
                  lambda c: ~c("size").above(2.5) & c("category").isin([1, 2]),
                  lambda c: (c("price") < 1.0) & (c("price") > 2.0)):
        pj = build(jal.col).compile(schema)
        pt = build(tal.col).compile(schema, device="cpu")
        for a, b in zip(fields(pj), fields(pt)):
            np.testing.assert_array_equal(a, b)


def _batch(scal, seeds):
    pairs = [compile_both(s, scal) for s in seeds]
    pairs = [p for p in pairs if p is not None]
    return (jp.stack([p[0] for p in pairs]), tp.stack([p[1] for p in pairs]))


def test_batched_eval_mask_stack_take_active_any(scal4):
    pj, pt = _batch(scal4, range(200, 216))
    np.testing.assert_array_equal(
        np.asarray(jp.active_any(pj)), tp.active_any(pt).numpy())
    mj = np.asarray(jax.vmap(lambda p: jp.eval_mask(p, jnp.asarray(scal4)))(
        pj))
    np.testing.assert_array_equal(mj, tp.eval_mask(pt, torch.as_tensor(
        scal4)).numpy())
    sel = np.asarray([3, 0, 3, 5])
    for a, b in zip(fields(jp.take(pj, sel)), fields(tp.take(pt, sel))):
        np.testing.assert_array_equal(a, b)
    conj_j = jp.stack([jp.Predicates.from_conditions(4, {0: (1.0, 3.0)}),
                       jp.Predicates.none(4)])
    conj_t = tp.stack([tp.Predicates.from_conditions(4, {0: (1.0, 3.0)},
                                                     device="cpu"),
                       tp.Predicates.none(4, device="cpu")])
    assert isinstance(conj_t, tp.Predicates)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda p: jp.eval_mask(p, jnp.asarray(scal4)))(
            conj_j)),
        tp.eval_mask(conj_t, torch.as_tensor(scal4)).numpy())


def _edges(scal, bins):
    lo, hi = scal.min(axis=0), scal.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    return (lo[:, None] + span[:, None]
            * np.linspace(0.0, 1.0 + 1e-6, bins + 1)[None, :]
            ).astype(np.float32)


def test_soft_encode_matches_jax(scal4):
    edges = _edges(scal4, 8)
    pj, pt = _batch(scal4, range(300, 340))
    want = np.asarray(jax.vmap(lambda p: jp.soft_encode(
        p, jnp.asarray(edges)))(pj))
    got = tp.soft_encode(pt, torch.as_tensor(edges)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    # point predicates, ±inf bounds, C=1 shim
    shim_j = jp.Predicates.from_conditions(
        4, {0: (3.0, 3.0), 2: (-np.inf, 2.0), 3: (500.0, np.inf)})
    shim_t = tp.Predicates.from_conditions(
        4, {0: (3.0, 3.0), 2: (-np.inf, 2.0), 3: (500.0, np.inf)},
        device="cpu")
    np.testing.assert_allclose(
        tp.soft_encode(shim_t, torch.as_tensor(edges)).numpy(),
        np.asarray(jp.soft_encode(shim_j, jnp.asarray(edges))), atol=TOL)


def test_value_encode_right_edge_rule_matches_jax(scal4):
    """Values sitting exactly on interior bin edges one-hot into the bin on
    their right (``side="right"``), as the histograms count them."""
    edges = _edges(scal4, 16)
    values = np.stack([edges[:, 3], edges[:, 7], edges[:, 0], edges[:, -1],
                       scal4[5], scal4[17]]).astype(np.float32)  # (6, M)
    want = np.asarray(jax.vmap(lambda v: jp.value_encode(
        v, jnp.asarray(edges)))(jnp.asarray(values)))
    got = tp.value_encode(torch.as_tensor(values), torch.as_tensor(edges))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[0, :, 3].all()  # edge 3 -> bin 3, not bin 2


def test_histogram_build_and_selectivity_match_jax(scal4):
    hj = jh.build(jnp.asarray(scal4), 64)
    ht = th.build(torch.as_tensor(scal4), 64)
    np.testing.assert_allclose(ht.edges.numpy(), np.asarray(hj.edges),
                               rtol=1e-6)
    np.testing.assert_array_equal(ht.prefix.numpy(), np.asarray(hj.prefix))
    # the port's estimator on the JAX histogram, carried across
    hc = convert.histograms(np.asarray(hj.edges), np.asarray(hj.prefix),
                            np.asarray(hj.n_rows), device="cpu")
    for seeds in (range(400, 430), range(430, 460)):
        pj, pt = _batch(scal4, seeds)
        want = np.asarray(jax.vmap(
            lambda p: jh.estimate_selectivity(hj, p))(pj))
        got = th.estimate_selectivity(hc, pt).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=TOL)
    # ±inf bounds and a point predicate, C=1 and C=4 with padding
    ps_j = jp.PredicateSet.from_clauses(
        4, [{2: (-np.inf, 2.0)}, {3: (700.0, np.inf)}, {0: (4.0, 4.0)}],
        n_clauses=4)
    ps_t = tp.PredicateSet.from_clauses(
        4, [{2: (-np.inf, 2.0)}, {3: (700.0, np.inf)}, {0: (4.0, 4.0)}],
        n_clauses=4, device="cpu")
    np.testing.assert_allclose(
        float(th.estimate_selectivity(hc, ps_t)),
        float(jh.estimate_selectivity(hj, ps_j)), atol=TOL)


@pytest.mark.parametrize("build,want", [
    (lambda c: c(0) != 0.0, lambda x: x != 0.0),
    # the tree the JAX package's property test draws at seed 667
    (lambda c: ~c(0).isin([1.0, 0.0, 5.0]),
     lambda x: ~np.isin(x, [1.0, 0.0, 5.0])),
])
def test_negated_zero_equality_keeps_its_denormal_bounds(build, want):
    """A negated equality at 0 compiles to the strict bounds
    ``nextafter(0, ±inf)`` = ±1.4e-45, float32 denormals. The JAX
    package's ``eval_mask`` on the CPU flushes them to zero and admits the
    rows holding 0 (ROADMAP Queue 3); the port keeps them and excludes
    those rows, as the NumPy oracle does, on the seed-667 data."""
    rng = np.random.default_rng(667)
    scal = np.stack([
        rng.integers(0, 8, 400).astype(np.float32),
        rng.uniform(-5.0, 5.0, 400).astype(np.float32),
        rng.lognormal(0.5, 1.0, 400).astype(np.float32)], axis=1)
    assert (scal[:, 0] == 0).sum() == 43
    ps = build(tal.col).compile(m=3, device="cpu")
    tiny = np.nextafter(np.float32(0), np.float32(1))
    assert (ps.lo.numpy() == tiny).any() and (ps.hi.numpy() == -tiny).any()
    got = tp.eval_mask(ps, torch.as_tensor(scal)).numpy()
    np.testing.assert_array_equal(got, want(scal[:, 0]))
