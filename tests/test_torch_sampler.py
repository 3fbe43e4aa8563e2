"""The port's samplers (picaso_tpu_torch.sampler) against the JAX
package's (picaso_tpu.sampler): the same seed and the same log-likelihood
give bit-identical samples, weights, evidence, iteration counts and
chains, on the analytic problems of tests/test_retrieval.py:23-127; a
checkpoint written by either package resumes in the other."""

import numpy as np
import pytest

from picaso_tpu import sampler as jsampler
from picaso_tpu_torch import sampler as tsampler


def _gaussian(sig=0.05, mu=0.5):
    def loglike(x):
        x = np.atleast_2d(x)
        return (-0.5 * np.sum((x - mu) ** 2, axis=1) / sig ** 2
                - 0.5 * x.shape[1] * np.log(2 * np.pi * sig ** 2))
    return loglike


def _bimodal():
    """tests/test_retrieval.py's correlated bimodal 3D mixture."""
    m1 = np.array([0.3, 0.3, 0.3])
    m2 = np.array([0.72, 0.72, 0.72])
    sig, rho = 0.04, 0.7
    cov = sig ** 2 * (np.full((3, 3), rho) + (1 - rho) * np.eye(3))
    icov = np.linalg.inv(cov)
    lognorm = -0.5 * (3 * np.log(2 * np.pi) + np.log(np.linalg.det(cov)))

    def loglike(x):
        x = np.atleast_2d(x)
        d1, d2 = x - m1, x - m2
        l1 = -0.5 * np.einsum('ij,jk,ik->i', d1, icov, d1) + lognorm
        l2 = -0.5 * np.einsum('ij,jk,ik->i', d2, icov, d2) + lognorm
        return np.logaddexp(np.log(0.65) + l1, np.log(0.35) + l2)
    return loglike


def assert_same_result(port, ref):
    assert set(port) == set(ref)
    for key in ('samples', 'logl', 'weights', 'samples_equal'):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    for key in ('logz', 'niter', 'ess'):
        assert port[key] == ref[key], key


CASES = {
    # name: (loglike, ndim, nested_sample keyword arguments)
    'gaussian': (_gaussian(), 2, dict(nlive=150, seed=2, dlogz=0.1)),
    'bimodal_correlated': (_bimodal(), 3, dict(nlive=200, seed=5,
                                               dlogz=0.05)),
    'dynamic': (_gaussian(), 2, dict(nlive=120, seed=7, dlogz=0.1,
                                     dynamic=True)),
    'scalar_likelihood': (lambda x: float(_gaussian()(x)[0]), 2,
                          dict(nlive=40, seed=4, dlogz=0.5,
                               vectorized=False)),
}


@pytest.mark.parametrize('name', CASES)
def test_nested_sample_bitwise(name):
    loglike, ndim, kw = CASES[name]
    ref = jsampler.nested_sample(loglike, lambda u: u, ndim, **kw)
    port = tsampler.nested_sample(loglike, lambda u: u, ndim, **kw)
    assert isinstance(port, tsampler.NestedResult)
    assert_same_result(port, ref)
    if name == 'gaussian':      # test_retrieval.py's recovery criteria
        assert abs(port.logz) < 0.3
    if name == 'dynamic':
        assert abs(port.logz) < 0.4


def test_ensemble_sample_bitwise():
    mu = np.array([1.0, -2.0])
    sig = np.array([0.5, 1.5])

    def logp(x):
        return -0.5 * np.sum((x - mu) ** 2 / sig ** 2, axis=-1)

    p0 = np.random.default_rng(0).standard_normal((32, 2))
    jchain, jlps = jsampler.ensemble_sample(logp, p0, 300, seed=1)
    chain, lps = tsampler.ensemble_sample(logp, p0, 300, seed=1)
    np.testing.assert_array_equal(chain, jchain)
    np.testing.assert_array_equal(lps, jlps)
    flat = chain[150:].reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.2)
    # the scalar path
    jchain, _ = jsampler.ensemble_sample(logp, p0[:8], 20, seed=3,
                                         vectorized=False)
    chain, _ = tsampler.ensemble_sample(logp, p0[:8], 20, seed=3,
                                        vectorized=False)
    np.testing.assert_array_equal(chain, jchain)
    with pytest.raises(ValueError):
        tsampler.ensemble_sample(logp, p0[:7], 2)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """A checkpoint written by one package (the 10-tuple pickle) resumes in
    the other, to the same result as resuming in the writer."""
    def loglike(x):
        x = np.atleast_2d(x)
        return -0.5 * np.sum((x - 0.5) ** 2, axis=1) / 0.1 ** 2

    first, other = ((jsampler, tsampler) if writer == 'jax'
                    else (tsampler, jsampler))
    ck = str(tmp_path / 'ns.ckpt')
    first.nested_sample(loglike, lambda u: u, 2, nlive=100, seed=3,
                        max_iter=150, checkpoint_file=ck)
    with open(ck, 'rb') as f:
        state = f.read()
    same = first.nested_sample(loglike, lambda u: u, 2, nlive=100, seed=3,
                               checkpoint_file=ck, resume=True, dlogz=0.1)
    with open(ck, 'wb') as f:          # the resumed run rewrote it
        f.write(state)
    cross = other.nested_sample(loglike, lambda u: u, 2, nlive=100, seed=3,
                                checkpoint_file=ck, resume=True, dlogz=0.1)
    assert cross.niter > 100 and np.isfinite(cross.logz)
    assert_same_result(cross, same)


def test_device_backed_likelihood_is_copied():
    """A likelihood returning a read-only array (as a view of device
    memory) still works: the live set is a copy (sampler.py:270-272)."""
    def loglike(x):
        out = _gaussian()(x)
        out.setflags(write=False)
        return out

    res = tsampler.nested_sample(loglike, lambda u: u, 2, nlive=30, seed=1,
                                 max_iter=40)
    ref = jsampler.nested_sample(loglike, lambda u: u, 2, nlive=30, seed=1,
                                 max_iter=40)
    assert_same_result(res, ref)


def test_nested_result_attribute_protocol():
    import copy
    r = tsampler.NestedResult(logz=1.0)
    assert r.logz == 1.0
    assert not hasattr(r, 'fitpars')
    assert getattr(r, 'nope', None) is None
    assert copy.deepcopy(r)['logz'] == 1.0
