"""On-device wavefront compaction (trace_compacted): estimator parity with
trace() and correct survivor bookkeeping (the WorkStealingScheduler.cs:9-30
replacement BASELINE names)."""

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp import examples
from ptsharp.integrator import (
    IntegratorConfig,
    RayState,
    _compact_state,
    trace,
    trace_compacted,
)


def _cornell_rays(n=4096, seed=0):
    scene, cam, _r, icfg = examples.build("cornell")
    w = h = 64
    xs = jnp.arange(n, dtype=jnp.int32)
    px, py = xs % w, (xs // w) % h
    kj, kt = jax.random.split(jax.random.PRNGKey(seed))
    ju, jv = jax.random.uniform(kj, (2, n))
    org, dirn = cam.cast_rays(px, py, w, h, ju, jv)
    return scene, icfg, org, dirn, kt


def test_compact_state_moves_survivors_front():
    r = 64
    rng = np.random.default_rng(0)
    alive = jnp.asarray(rng.random(r) < 0.3)
    st = RayState(
        org=jnp.arange(r * 3, dtype=jnp.float32).reshape(r, 3),
        dirn=jnp.ones((r, 3)),
        throughput=jnp.ones((r, 3)),
        radiance=jnp.zeros((r, 3)),
        emission_ok=jnp.ones(r, bool),
        alive=alive,
    )
    n_alive = int(alive.sum())
    small, src = _compact_state(st, 32)
    assert bool(small.alive[:n_alive].all())
    assert not bool(small.alive[n_alive:].any())
    # gathered lanes carry their own origin rows
    np.testing.assert_array_equal(
        np.asarray(small.org), np.asarray(st.org)[np.asarray(src)]
    )


def test_trace_compacted_matches_trace():
    """Same integral: the compacted estimator's converged image matches
    plain trace on the RR cornell config."""
    scene, icfg, org, dirn, key = _cornell_rays(8192)
    icfg = IntegratorConfig(max_bounces=8, russian_roulette=True,
                            rr_start_depth=2)
    a = trace(scene, icfg, org, dirn, key)
    b = trace_compacted(scene, icfg, org, dirn, key, min_cap=256)
    ra = np.asarray(a.radiance)
    rb = np.asarray(b.radiance)
    assert np.isfinite(rb).all()
    # depths [0, rr_start+1) are identical random chains -> only the tail
    # differs in lane-keyed randomness; means must agree statistically
    np.testing.assert_allclose(rb.mean(), ra.mean(), rtol=0.03)
    # lanes that died before the compaction point never re-enter the tail:
    # trace() shares the prefix key chain, so those lanes are bit-identical
    from ptsharp.integrator import _trace_prefix

    state, _rr, _a, _n, _k = _trace_prefix(scene, icfg, org, dirn, key,
                                           None, 1, 3)
    dead = ~np.asarray(state.alive)
    assert dead.any()
    # borderline Russian-roulette coins can flip between the two graph
    # partitions (fusion changes fp rounding of the survival threshold), so
    # a small fraction of lanes legitimately diverges; the overwhelming
    # majority must be bit-preserved by the scatter-back
    diff = np.abs(rb[dead] - ra[dead])
    close = diff <= 1e-5 + 1e-5 * np.abs(ra[dead])
    # tightened after the round-4 trace-loop unification (one _trace_span
    # serves every variant): measured bit-preserved fraction 0.99916
    assert close.mean() > 0.998


def test_reservoir_compact_unbiased_weights():
    """_reservoir_compact: when survivors exceed the cap, exactly cap lanes
    survive, each reweighted by S/cap, so total expected throughput is
    preserved; when S <= cap, all survive unweighted."""
    from ptsharp.integrator import _reservoir_compact

    r = 256
    rng = np.random.default_rng(1)
    alive = jnp.asarray(rng.random(r) < 0.5)
    st = RayState(
        org=jnp.asarray(rng.normal(size=(r, 3)).astype(np.float32)),
        dirn=jnp.ones((r, 3)),
        throughput=jnp.ones((r, 3)),
        radiance=jnp.zeros((r, 3)),
        emission_ok=jnp.ones(r, bool),
        alive=alive,
    )
    s = int(alive.sum())
    cap = s // 2
    small, src = _reservoir_compact(st, cap, jax.random.PRNGKey(0))
    assert int(small.alive.sum()) == cap  # exactly cap survivors
    # each survivor's throughput carries the S/cap reweight
    surv_tp = np.asarray(small.throughput)[np.asarray(small.alive)]
    np.testing.assert_allclose(surv_tp, s / cap, rtol=1e-6)
    # no-overflow case: all alive kept, unweighted
    small2, _ = _reservoir_compact(st, s + 10, jax.random.PRNGKey(0))
    assert int(small2.alive.sum()) == s
    surv_tp2 = np.asarray(small2.throughput)[np.asarray(small2.alive)]
    np.testing.assert_allclose(surv_tp2, 1.0)


def test_trace_compacted_static_matches_trace():
    """The sync-free static-schedule estimator converges to the same
    integral as plain trace on the RR cornell config."""
    from ptsharp.integrator import trace_compacted_static

    scene, icfg, org, dirn, key = _cornell_rays(8192)
    icfg = IntegratorConfig(max_bounces=8, russian_roulette=True,
                            rr_start_depth=2)
    a = trace(scene, icfg, org, dirn, key)
    b = trace_compacted_static(scene, icfg, org, dirn, key, min_cap=256)
    ra, rb = np.asarray(a.radiance), np.asarray(b.radiance)
    assert np.isfinite(rb).all()
    np.testing.assert_allclose(rb.mean(), ra.mean(), rtol=0.03)
    # with generous caps (no overflow possible) the estimator is exact for
    # lanes dead before the first compaction point (shared prefix chain)
    c = trace_compacted_static(scene, icfg, org, dirn, key,
                               schedule=((3, 4096),))
    rc = np.asarray(c.radiance)
    np.testing.assert_allclose(rc.mean(), ra.mean(), rtol=0.03)


def test_trace_compacted_fallback_paths():
    """No RR, or nothing culled -> falls back to plain trace results."""
    scene, icfg, org, dirn, key = _cornell_rays(1024)
    cfg = IntegratorConfig(max_bounces=3)  # no RR
    a = trace(scene, cfg, org, dirn, key)
    b = trace_compacted(scene, cfg, org, dirn, key)
    np.testing.assert_allclose(np.asarray(a.radiance), np.asarray(b.radiance))


def test_no_rr_compaction_engages_and_matches():
    """RR-less traces now compact too (env-miss/emissive decay): the
    static tail must preserve the estimator. With caps >= survivors the
    reservoir never reweights, so radiance matches the plain trace up to
    scatter-add ordering."""
    import jax
    import jax.numpy as jnp

    from ptsharp import examples
    from ptsharp.integrator import (
        IntegratorConfig, compaction_schedule, trace, trace_compacted_static,
    )

    scene, cam, _rc, _ic = examples.build("bunny", width=64, height=64,
                                          subdivisions=3)
    cfg = IntegratorConfig(max_bounces=4, russian_roulette=False)
    r = 4096
    key = jax.random.PRNGKey(5)
    xs = jnp.arange(r, dtype=jnp.int32)
    ju, jv = jax.random.uniform(key, (2, r))
    org, dirn = cam.cast_rays(xs % 64, (xs // 64) % 64, 64, 64, ju, jv)

    assert compaction_schedule(cfg, 1 << 18), \
        "no-RR schedule must engage at production widths"
    # caps >= wavefront survivors: no reservoir reweighting, exact tail
    big = ((2, r // 2),)
    a = trace(scene, cfg, org, dirn, key)
    b = trace_compacted_static(scene, cfg, org, dirn, key, schedule=big)
    assert jnp.allclose(a.radiance.sum(0), b.radiance.sum(0),
                        rtol=2e-2, atol=2e-2), (
        a.radiance.sum(), b.radiance.sum())
