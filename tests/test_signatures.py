"""Signature metrics: analytic cases, bias directions, batching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.utils.signatures import (
    fdc_fhv,
    fdc_flv,
    fdc_fms,
    flashiness,
    runoff_ratio,
)


@pytest.fixture
def hydrograph():
    rng = np.random.default_rng(0)
    T = 1000
    base = rng.gamma(1.2, 2.0, T) + 0.1
    return np.sort(base)[::-1].copy()[rng.permutation(T)]


class TestFHV:
    def test_zero_for_identical(self, hydrograph):
        assert float(fdc_fhv(hydrograph, hydrograph)) == pytest.approx(
            0.0, abs=1e-4)

    def test_sign_and_magnitude(self, hydrograph):
        # Uniform doubling of every flow doubles the top segment too.
        assert float(fdc_fhv(hydrograph, 2 * hydrograph)
                     ) == pytest.approx(100.0, abs=0.01)
        assert float(fdc_fhv(hydrograph, 0.5 * hydrograph)
                     ) == pytest.approx(-50.0, abs=0.01)

    def test_only_top_segment_matters(self, hydrograph):
        # Shrinking flows below the top 2% can never enter the sorted
        # top segment, so FHV must be unchanged.
        q = np.sort(hydrograph)[::-1]
        sim = q.copy()
        sim[20:] *= 0.5    # everything below the top-2% cut (20/1000)
        assert float(fdc_fhv(q, sim, h=0.02)) == pytest.approx(0.0,
                                                               abs=1e-4)

    def test_batched_axis(self, hydrograph):
        sims = np.stack([hydrograph, 2 * hydrograph], axis=1)  # (T, 2)
        out = np.asarray(fdc_fhv(hydrograph[:, None], sims, axis=0))
        np.testing.assert_allclose(out, [0.0, 100.0], atol=0.01)


class TestFLV:
    def test_zero_for_identical(self, hydrograph):
        assert float(fdc_flv(hydrograph, hydrograph)) == pytest.approx(
            0.0, abs=1e-4)

    def test_baseflow_inflation_positive(self, hydrograph):
        # Raising ONLY the low flows (in a way that preserves ordering)
        # must produce positive FLV and ~zero FHV.
        q = np.sort(hydrograph)[::-1]
        sim = q.copy()
        low = slice(700, 1000)
        sim[low] = sim[low] ** 0.5  # lifts small values toward 1
        sim[low] = np.sort(sim[low])[::-1] * (q[699] / max(sim[low]))
        flv = float(fdc_flv(q, sim))
        assert np.isfinite(flv) and flv != 0.0
        assert float(fdc_fhv(q, sim)) == pytest.approx(0.0, abs=1e-4)

    def test_jittable(self, hydrograph):
        f = jax.jit(lambda o, s: fdc_flv(o, s))
        assert np.isfinite(float(f(jnp.asarray(hydrograph),
                                   jnp.asarray(hydrograph * 1.1))))


class TestFMS:
    def test_zero_for_identical(self, hydrograph):
        assert float(fdc_fms(hydrograph, hydrograph)) == pytest.approx(
            0.0, abs=1e-4)

    def test_flattened_fdc_negative(self, hydrograph):
        # Compressing flows toward their median flattens the FDC slope.
        med = np.median(hydrograph)
        sim = med + 0.3 * (hydrograph - med)
        sim = np.maximum(sim, 1e-3)
        assert float(fdc_fms(hydrograph, sim)) < -10.0

    def test_steepened_fdc_positive(self, hydrograph):
        med = np.median(hydrograph)
        sim = np.maximum(med + 2.5 * (hydrograph - med), 1e-3)
        assert float(fdc_fms(hydrograph, sim)) > 10.0


class TestShapeSignatures:
    def test_flashiness_analytic(self):
        assert float(flashiness(np.ones(100))) == pytest.approx(
            0.0, abs=1e-6)
        # Alternating 0/2: each step |dq|=2 (99 steps), sum q = 100.
        q = np.tile([0.0, 2.0], 50)
        assert float(flashiness(q)) == pytest.approx(198.0 / 100.0,
                                                     rel=1e-5)

    def test_runoff_ratio(self):
        q = np.full(10, 2.0)
        p = np.full(10, 5.0)
        assert float(runoff_ratio(q, p)) == pytest.approx(0.4, rel=1e-6)

    def test_batched(self):
        q = np.random.default_rng(0).uniform(0, 5, (100, 8))
        out = np.asarray(flashiness(q, axis=0))
        assert out.shape == (8,)


class TestModelIntegration:
    def test_gr4j_signature_diagnostics(self):
        """Signatures evaluate a whole MC ensemble in one batched call
        and respond in the expected direction to a known structural
        change (raised percolation -> flashier, weaker baseflow)."""
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(1)
        T = 730
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        model = GR4J(params={'x1': 350.0, 'x2': 0.5, 'x3': 120.0,
                             'x4': 1.8})
        qobs = np.asarray(model.simulate(prec, etp, s_init=0.4,
                                         r_init=0.4))[:, 0]
        params = {'x1': np.array([350.0, 120.0]),
                  'x2': np.array([0.5, 0.5]),
                  'x3': np.array([120.0, 35.0]),
                  'x4': np.array([1.8, 1.2])}
        qsim = np.asarray(model.simulate(prec, etp, s_init=0.4,
                                         r_init=0.4, params=params))

        fhv = np.asarray(fdc_fhv(qobs[:, None], qsim, axis=0))
        fms = np.asarray(fdc_fms(qobs[:, None], qsim, axis=0))
        assert fhv.shape == (2,) and np.isfinite(fhv).all()
        # Member 0 IS the truth: all its signature biases ~ 0.
        assert abs(fhv[0]) < 1e-3 and abs(fms[0]) < 1e-3
        # Member 1 (small stores, quick routing) is flashier: higher
        # peaks and a steeper mid-FDC than the truth.
        assert fhv[1] > 5.0
        rb = np.asarray(flashiness(qsim, axis=0))
        assert rb[1] > rb[0]
