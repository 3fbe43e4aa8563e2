"""Samplers for Bayesian retrievals: host numpy around the forward model.

Copy of ``picaso_tpu/sampler.py`` for the PyTorch port, which must not
import the JAX package.  Two self-contained samplers whose parallel axis --
the walker / live-point batch -- is one call of the log-likelihood on a
[n, ndim] array, which a caller makes one batch of forward models on the
card (``pipeline.forward_batch``) or a loop of front-door spectra
(``driver.log_likelihood``):

* :func:`ensemble_sample` -- affine-invariant ensemble MCMC (Goodman &
  Weare 2010 stretch move).
* :func:`nested_sample` -- nested sampling with MultiNest-style
  multi-ellipsoid bounds (recursive 2-means splits accepted on volume
  reduction, Feroz & Hobson 2008) seeding covariance-scaled random
  walks, varying-live-point weight bookkeeping, optional
  posterior-focused dynamic batches (Higson et al. 2019), evidence +
  effective sample size, and checkpoint/resume via pickle.

Every random draw and every floating-point operation is the JAX package's,
in the same order: the same seed and the same log-likelihood give
bit-identical samples, weights and evidence in both packages, and a
checkpoint written by either resumes in the other (the same 10-tuple).
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = ['ensemble_sample', 'nested_sample', 'NestedResult']


def ensemble_sample(log_prob_fn, p0, nsteps, seed=0, a=2.0, vectorized=True,
                    progress=False):
    """Affine-invariant ensemble MCMC (stretch move).

    Parameters
    ----------
    log_prob_fn : callable
        Maps [nwalkers, ndim] -> [nwalkers] when ``vectorized`` (the fast
        path: one batch of forward models per call), else a scalar
        function.
    p0 : array [nwalkers, ndim]
        Initial walker positions (nwalkers must be even).
    Returns (chain [nsteps, nwalkers, ndim], log_probs [nsteps, nwalkers]).
    """
    rng = np.random.default_rng(seed)
    p = np.array(p0, dtype=float)
    nwalkers, ndim = p.shape
    if nwalkers % 2:
        raise ValueError('nwalkers must be even')
    if not vectorized:
        flp = log_prob_fn
        log_prob_fn = lambda x: np.array([flp(xi) for xi in x])
    lp = np.asarray(log_prob_fn(p))
    chain = np.zeros((nsteps, nwalkers, ndim))
    lps = np.zeros((nsteps, nwalkers))
    half = nwalkers // 2
    for step in range(nsteps):
        for first in (True, False):
            sel = slice(0, half) if first else slice(half, nwalkers)
            oth = slice(half, nwalkers) if first else slice(0, half)
            S = p[sel]
            C = p[oth]
            z = ((a - 1.0) * rng.random(half) + 1) ** 2 / a
            partners = C[rng.integers(0, half, half)]
            prop = partners + z[:, None] * (S - partners)
            lp_prop = np.asarray(log_prob_fn(prop))
            log_accept = (ndim - 1) * np.log(z) + lp_prop - lp[sel]
            accept = np.log(rng.random(half)) < log_accept
            p[sel] = np.where(accept[:, None], prop, S)
            lp[sel] = np.where(accept, lp_prop, lp[sel])
        chain[step] = p
        lps[step] = lp
        if progress and step % max(1, nsteps // 10) == 0:
            print(f'step {step}/{nsteps} <logp>={lp.mean():.2f}')
    return chain, lps


class NestedResult(dict):
    """Dict with attribute access: samples, logwt, logz, logl, niter."""

    def __getattr__(self, name):
        # AttributeError (not KeyError) for missing names so hasattr,
        # 3-arg getattr, and copy.deepcopy's dunder probes behave
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


# ---------------------------------------------------------------------------
# multi-ellipsoid bounding (MultiNest-style, Feroz & Hobson 2008)
# ---------------------------------------------------------------------------

class _Ellipsoid:
    __slots__ = ('mean', 'chol', 'inv_chol', 'logvol', 'n')

    def __init__(self, pts, enlarge):
        # ``enlarge`` is a VOLUME factor applied beyond the
        # furthest-point scaling (the sample hull underestimates the
        # true iso-likelihood contour, which biases logZ low if clipped)
        n, ndim = pts.shape
        self.n = n
        self.mean = pts.mean(axis=0)
        cov = np.cov(pts.T) if n > ndim + 1 else np.eye(ndim) * 1e-4
        cov = np.atleast_2d(cov) + 1e-12 * np.eye(ndim)
        # scale so every point is inside, then enlarge
        try:
            inv = np.linalg.inv(cov)
        except np.linalg.LinAlgError:
            cov = np.eye(ndim) * 1e-4
            inv = np.linalg.inv(cov)
        d = pts - self.mean
        k = np.einsum('ij,jk,ik->i', d, inv, d).max()
        cov = cov * max(k, 1e-10) * enlarge ** (2.0 / ndim)
        self.chol = np.linalg.cholesky(cov)
        self.inv_chol = np.linalg.inv(self.chol)
        self.logvol = float(np.log(np.abs(np.diag(self.chol))).sum())

    def contains(self, x):
        z = (np.atleast_2d(x) - self.mean) @ self.inv_chol.T
        return (z ** 2).sum(axis=-1) <= 1.0

    def sample(self, rng, size):
        ndim = len(self.mean)
        z = rng.standard_normal((size, ndim))
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        r = rng.random(size) ** (1.0 / ndim)
        return self.mean + (z * r[:, None]) @ self.chol.T


def _kmeans2(pts, rng, iters=10):
    """2-means split of the live points."""
    c = pts[rng.choice(len(pts), 2, replace=False)]
    for _ in range(iters):
        d = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        if (lab == 0).sum() < 2 or (lab == 1).sum() < 2:
            return None
        c = np.stack([pts[lab == 0].mean(0), pts[lab == 1].mean(0)])
    return lab


def _bounding_ellipsoids(pts, rng, enlarge=2.0, max_ell=8):
    """Recursive 2-means decomposition, accepted when it shrinks the
    total bounding volume (the multimodal split criterion)."""
    ndim = pts.shape[1]
    ells = [_Ellipsoid(pts, enlarge)]
    groups = [pts]
    changed = True
    while changed and len(ells) < max_ell:
        changed = False
        for i, (e, g) in enumerate(zip(ells, groups)):
            if len(g) < 4 * ndim:
                continue
            lab = _kmeans2(g, rng)
            if lab is None:
                continue
            try:
                e1 = _Ellipsoid(g[lab == 0], enlarge)
                e2 = _Ellipsoid(g[lab == 1], enlarge)
            except np.linalg.LinAlgError:
                continue
            if np.logaddexp(e1.logvol, e2.logvol) < e.logvol - 0.1:
                ells[i:i + 1] = [e1, e2]
                groups[i:i + 1] = [g[lab == 0], g[lab == 1]]
                changed = True
                break
    return ells


def _sample_from_ellipsoids(rng, ells, size):
    """Volume-weighted draw with union-multiplicity correction."""
    logvols = np.array([e.logvol for e in ells])
    p = np.exp(logvols - logvols.max())
    p /= p.sum()
    which = rng.choice(len(ells), size=size, p=p)
    out = np.concatenate([ells[k].sample(rng, 1) for k in which])
    # accept each draw with probability 1/q (q = how many ellipsoids
    # contain it) so the union is sampled uniformly
    q = np.stack([e.contains(out) for e in ells]).sum(0)
    keep = rng.random(size) < 1.0 / np.maximum(q, 1)
    return out[keep]


def _replace_point(rng, u, logl, logl_star, worst, ells, loglike_batch,
                   walks, chol, stats):
    """One likelihood-constrained replacement draw.

    Primary: uniform rejection sampling from the multi-ellipsoid bound
    (batched likelihood evaluations).  Fallback (when the bound's
    acceptance collapses): live-point-covariance random walk.
    Returns (new_u, new_logl).
    """
    nlive, ndim = u.shape
    cur_u = cur_logl = None
    n_walk = walks
    # --- ellipsoid rejection sampling (seeds the walk) ---
    if ells is not None and stats['ell_eff'] > 0.05:
        for _ in range(4):
            props = _sample_from_ellipsoids(rng, ells, 32)
            if not len(props):
                continue
            inside = np.all((props > 0) & (props < 1), axis=1)
            props = props[inside]
            if not len(props):
                continue
            pl = loglike_batch(props)
            stats['ell_tried'] += len(props)
            ok = np.where(pl > logl_star)[0]
            if len(ok):
                stats['ell_accepted'] += 1
                k = int(ok[int(rng.integers(len(ok)))])
                # a short decorrelating walk mops up any residual
                # boundary clipping of the sample-built ellipsoid
                cur_u, cur_logl = props[k], float(pl[k])
                n_walk = max(3, walks // 5)
                break
        if cur_u is None:
            stats['ell_eff'] *= 0.5  # bound is stale/too big — back off

    # --- covariance random walk ---
    if cur_u is None:
        start = int(rng.integers(nlive))
        while start == worst and nlive > 1:
            start = int(rng.integers(nlive))
        cur_u, cur_logl = u[start].copy(), logl[start]
    scale = 1.0
    for _ in range(n_walk):
        steps = rng.standard_normal((4, ndim)) @ chol.T
        props = np.clip(cur_u[None, :] + scale * steps, 1e-10, 1 - 1e-10)
        pl = loglike_batch(props)
        ok = pl > logl_star
        if ok.any():
            k = int(np.argmax(ok))
            cur_u, cur_logl = props[k], float(pl[k])
            scale *= 1.2
        else:
            scale *= 0.7
    return cur_u, cur_logl


def _ns_run(loglike_batch, prior_transform, ndim, nlive, rng, dlogz=0.5,
            max_iter=100000, walks=25, u_seed=None,
            first_update=None, verbose=False, checkpoint=None,
            state=None):
    """One nested-sampling run.

    Returns (dead_u, dead_v, dead_logl, n_at_death) where n_at_death is
    the number of live points when each dead point was removed — the
    varying-n bookkeeping that makes runs mergeable (dynamic nested
    sampling, Higson et al. 2019)."""
    logz = -1e300
    logvol = 0.0
    if state is not None:
        # 10-tuple since the logz/logvol fix; accept the old 8-tuple
        # (termination stats then rebuild conservatively)
        if len(state) == 10:
            (u, v, logl, dead_u, dead_v, dead_logl, n_at, it,
             logz, logvol) = state
        else:
            (u, v, logl, dead_u, dead_v, dead_logl, n_at, it) = state
            if len(dead_logl):
                logwt, logz = _weights_from_run(np.asarray(dead_logl),
                                                np.asarray(n_at))
                logvol = -len(dead_logl) / nlive
    else:
        if u_seed is not None:
            u = u_seed.copy()
        else:
            u = rng.random((nlive, ndim))
        v = np.asarray(prior_transform(u))
        # copy: a device-backed loglike returns a read-only numpy view,
        # and the live set is updated in place
        logl = np.array(loglike_batch(v))
        dead_u, dead_v, dead_logl, n_at = [], [], [], []
        it = 0
    first_update = first_update or max(nlive // 2, 20)
    ells = None
    chol = np.eye(ndim) * 0.1
    stats = {'ell_eff': 1.0, 'ell_tried': 0, 'ell_accepted': 0}
    dlv = 1.0 / nlive
    while it < max_iter:
        if it % max(nlive // 4, 10) == 0 and it >= first_update:
            ells = _bounding_ellipsoids(u, rng)
            stats['ell_eff'] = 1.0
            cov = np.cov(u.T) + 1e-10 * np.eye(ndim)
            try:
                chol = np.linalg.cholesky(cov)
            except np.linalg.LinAlgError:
                chol = np.eye(ndim) * 0.1
        worst = int(np.argmin(logl))
        logl_star = float(logl[worst])
        logz = np.logaddexp(logz, logvol - np.log(nlive) + logl_star)
        dead_u.append(u[worst].copy())
        dead_v.append(np.asarray(v[worst]).copy())
        dead_logl.append(logl_star)
        n_at.append(nlive)
        logvol -= dlv
        new_u, new_logl = _replace_point(
            rng, u, logl, logl_star, worst, ells,
            lambda x: np.asarray(loglike_batch(
                np.asarray(prior_transform(x)))),
            walks, chol, stats)
        u[worst] = new_u
        v = np.asarray(v)
        v[worst] = np.asarray(prior_transform(new_u[None]))[0]
        logl[worst] = new_logl
        it += 1
        if np.logaddexp(logz, logvol + logl.max()) - logz < dlogz:
            break
        if verbose and it % 200 == 0:
            print(f'  it={it} logl*={logl_star:.2f} logz={logz:.2f} '
                  f"ells={len(ells) if ells else 0}")
        if checkpoint is not None and it % 100 == 0:
            with open(checkpoint, 'wb') as f:
                pickle.dump((u, np.asarray(v), logl, dead_u, dead_v,
                             dead_logl, n_at, it, logz, logvol), f)
    # retire remaining live points with shrinking n
    order = np.argsort(logl)
    for j, i in enumerate(order):
        dead_u.append(u[i].copy())
        dead_v.append(np.asarray(v[i]).copy())
        dead_logl.append(float(logl[i]))
        n_at.append(nlive - j)
    return (np.asarray(dead_u), np.asarray(dead_v),
            np.asarray(dead_logl), np.asarray(n_at))


def _weights_from_run(dead_logl, n_at):
    """ln-volumes/weights for a (possibly merged) run with varying n."""
    logvols = -np.cumsum(1.0 / n_at)
    logvols = np.concatenate([[0.0], logvols[:-1]])
    # w_i = X_i * (1 - e^{-1/n_i}) * L_i
    logwt = logvols + np.log1p(-np.exp(-1.0 / n_at)) + dead_logl
    logz = float(np.logaddexp.reduce(logwt))
    return logwt, logz


def nested_sample(loglike_fn, prior_transform, ndim, nlive=200,
                  dlogz=0.5, max_iter=100000, seed=0, walks=25,
                  checkpoint_file=None, resume=False, vectorized=True,
                  verbose=False, dynamic=False, nlive_batch=None,
                  frac_remain=0.9):
    """Nested sampling with multi-ellipsoid bounds + dynamic batches.

    The likelihood-constrained prior is sampled by MultiNest-style
    rejection from a recursive 2-means multi-ellipsoid decomposition of
    the live points (handles curved/multimodal posteriors), falling back
    to a live-point-covariance random walk when the bound goes stale.
    Likelihood evaluations are batched throughout: pass
    ``vectorized=True`` with a likelihood that evaluates the whole
    [n, ndim] batch (one ``pipeline.forward_batch``) per call.

    ``dynamic=True`` adds a posterior-focused batch of ``nlive_batch``
    live points over the logL range holding ``frac_remain`` of the
    posterior mass, merged with the varying-n weighting of dynamic nested
    sampling (Higson et al. 2019) — more effective samples per
    likelihood call where the posterior actually lives.

    Checkpoint/resume mirrors the dynesty capability the reference's
    driver exposes (driver.py:415-426); the pickle is the JAX package's
    10-tuple, so a checkpoint resumes in either package.
    """
    rng = np.random.default_rng(seed)
    if not vectorized:
        fl = loglike_fn
        loglike_fn = lambda x: np.array([fl(xi) for xi in x])

    def loglike_batch(x):
        return np.asarray(loglike_fn(np.asarray(x)))

    state = None
    if resume and checkpoint_file is not None:
        with open(checkpoint_file, 'rb') as f:
            state = pickle.load(f)

    dead_u, dead_v, dead_logl, n_at = _ns_run(
        loglike_batch, prior_transform, ndim, nlive, rng, dlogz=dlogz,
        max_iter=max_iter, walks=walks, verbose=verbose,
        checkpoint=checkpoint_file, state=state)

    if dynamic:
        logwt, _ = _weights_from_run(dead_logl, n_at)
        wt = np.exp(logwt - logwt.max())
        wt /= wt.sum()
        csum = np.cumsum(wt[np.argsort(dead_logl)])
        sorted_logl = np.sort(dead_logl)
        lo = sorted_logl[np.searchsorted(csum, (1 - frac_remain) / 2)]
        nb = nlive_batch or nlive
        # Seed the batch with (approximately) UNIFORM prior draws above
        # lo: each seed is an independent likelihood-constrained
        # replacement draw at threshold lo (ellipsoid rejection + walk),
        # exactly how in-run replacements are made.  Perturbed dead
        # points would be logX-distributed, not volume-uniform, which
        # breaks the shrinkage bookkeeping the Higson merge relies on.
        pool = dead_u[dead_logl > lo]
        pool_logl = dead_logl[dead_logl > lo]
        if len(pool) >= 2 * ndim:
            ells_b = _bounding_ellipsoids(pool, rng)
            cov_b = np.cov(pool.T) + 1e-10 * np.eye(ndim)
            try:
                chol_b = np.linalg.cholesky(cov_b)
            except np.linalg.LinAlgError:
                chol_b = np.eye(ndim) * 0.1
            stats_b = {'ell_eff': 1.0, 'ell_tried': 0, 'ell_accepted': 0}
            seeds = np.empty((nb, ndim))
            for i in range(nb):
                seeds[i], _ = _replace_point(
                    rng, pool, pool_logl, float(lo),
                    int(rng.integers(len(pool))), ells_b,
                    lambda x: np.asarray(loglike_batch(
                        np.asarray(prior_transform(x)))),
                    walks, chol_b, stats_b)
            bd_u, bd_v, bd_logl, bd_n = _ns_run(
                loglike_batch, prior_transform, ndim, nb, rng,
                dlogz=dlogz, max_iter=max_iter, walks=walks,
                u_seed=seeds, first_update=0, verbose=verbose)
            # merge: at each dead point, n = sum of runs covering its logL
            all_u = np.concatenate([dead_u, bd_u])
            all_v = np.concatenate([dead_v, bd_v])
            all_logl = np.concatenate([dead_logl, bd_logl])
            order = np.argsort(all_logl)
            all_u, all_v = all_u[order], all_v[order]
            all_logl = all_logl[order]
            # base run covers (-inf, max]; batch covers (lo, batch_max]
            n_cover = np.interp(all_logl, np.sort(dead_logl),
                                np.sort(n_at)[::-1], left=nlive,
                                right=1).astype(float)
            # a run covers NOTHING above its own max logL
            n_base = np.where(all_logl <= dead_logl.max(), n_cover, 0.0)
            in_batch = (all_logl > lo) & (all_logl <= bd_logl.max())
            bcover = np.interp(all_logl, np.sort(bd_logl),
                               np.sort(bd_n)[::-1], left=nb, right=1)
            n_tot = np.maximum(n_base + np.where(in_batch, bcover, 0.0),
                               1.0)
            dead_u, dead_v, dead_logl = all_u, all_v, all_logl
            n_at = n_tot

    logwt, logz = _weights_from_run(dead_logl, n_at)
    wt = np.exp(logwt - logwt.max())
    wt /= wt.sum()
    n_dead = len(dead_logl)
    idx = np.random.default_rng(seed + 1).choice(n_dead, size=n_dead,
                                                 p=wt)
    ess = float(1.0 / (wt ** 2).sum())
    return NestedResult(samples=dead_v, logl=dead_logl, weights=wt,
                        logz=float(logz), samples_equal=dead_v[idx],
                        niter=n_dead, ess=ess)
