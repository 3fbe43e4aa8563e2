"""Free-parameter toolbox for retrievals.

Copy of ``picaso_tpu/parameterizations.py`` for the PyTorch port, which must
not import the JAX package: the reference ``Parameterize`` class's
pressure-temperature forms (Madhu & Seager 2009 with and without inversion,
Guillot 2010, temperature knots, ZJ24 gradient, isothermal), free chemistry
(constant, knots, gradient, background-gas fill), the grey clouds (hard
grey slab, decaying deck and slab, the brewster grey form) and the
Visscher chemistry, and the condensate clouds of ``virga.py``: the Mie
tables of ``load_cld_optical``/``mieff_dir``, ``get_particle_dist``,
``cloud_flex_fsed``, ``cloud_brewster_mie`` and ``cloud_virga``.  Plain
numpy on the host, the arithmetic of the JAX module line for line;
profiles and cloud tables are dicts of numpy columns (the JAX module makes
DataFrames), in the same column order.
"""

from __future__ import annotations

import numpy as np

from .wavelength import get_cld_input_grid

__all__ = ['Parameterize', 'picaso_format', 'cloud_averaging']


class Parameterize:
    """Builds profile/cloud inputs from free parameters
    (parameterizations.py:12-660)."""

    def __init__(self, pressure=None, nlevel=91, p_top=-6, p_bottom=2.5,
                 load_cld_optical=None, mieff_dir=None):
        self.pressure = (np.asarray(pressure) if pressure is not None
                         else np.logspace(p_top, p_bottom, nlevel))
        self.nlevel = len(self.pressure)
        self.mieff_dir = mieff_dir
        self.case = None
        # Mie tables for condensate-aware cloud parameterizations
        # (parameterizations.py:24-37): dict species -> virga mieff dict
        self.mie = {}
        if load_cld_optical is not None:
            from . import virga as vj
            if isinstance(load_cld_optical, str):
                load_cld_optical = [load_cld_optical]
            if mieff_dir is None:
                raise ValueError('load_cld_optical requires mieff_dir')
            for sp in load_cld_optical:
                mie = vj._load_gas_mieff(sp, mieff_dir)
                if mie is None:
                    raise FileNotFoundError(
                        f'{sp}.mieff not found in {mieff_dir}')
                self.mie[sp] = mie

    def add_class(self, picaso_inputs_class):
        self.case = picaso_inputs_class
        prof = picaso_inputs_class.inputs.get('atmosphere', {}).get(
            'profile')
        # a 1D profile (a dict of columns); a 3D GCM dict is left alone, as
        # the JAX module leaves any profile without DataFrame columns
        if (isinstance(prof, dict) and 'pressure' in prof
                and 'lat' not in prof):
            self.pressure = np.asarray(prof['pressure'])
            self.nlevel = len(self.pressure)

    # -- temperature parameterizations --------------------------------------
    def pt_isothermal(self, T):
        return np.zeros(self.nlevel) + T

    def pt_guillot(self, Teq, T_int, logg1, logKir, alpha, gravity_cgs=None):
        from scipy.special import expn
        g = ((gravity_cgs if gravity_cgs is not None
              else self.case.inputs['planet']['gravity']) / 100.0)
        kv1 = kv2 = 10 ** (logKir + logg1)
        kth = 10 ** logKir
        tint, tirr = T_int, np.sqrt(2.0) * Teq
        gamma1, gamma2 = kv1 / kth, kv2 / kth
        tau = self.pressure * 1e5 / g / kth

        def xi(gamma):
            return (2.0 / 3 + 2.0 / (3 * gamma)
                    * (1 + (gamma * tau / 2 - 1) * np.exp(-gamma * tau))
                    + 2.0 * gamma / 3 * (1 - tau ** 2 / 2)
                    * expn(2, gamma * tau))

        T4 = (3.0 * tint ** 4 / 4 * (2.0 / 3 + tau)
              + 3.0 * tirr ** 4 / 4 * (1 - alpha) * xi(gamma1)
              + 3.0 * tirr ** 4 / 4 * alpha * xi(gamma2))
        return T4 ** 0.25

    def pt_madhu_seager_09_noinversion(self, alpha_1, alpha_2, P_1, P_3,
                                       T_3, beta=0.5):
        """Madhu & Seager (2009) eq 2, no thermal inversion.

        Zone 1 (P<P_1): T = T_0 + (ln(P/P_0)/alpha_1)^(1/beta)
        Zone 2 (P_1<P<P_3): T = T_2 + (ln(P/P_2)/alpha_2)^(1/beta)
        Zone 3 (P>P_3): isothermal at T_3; continuity fixes T_0, T_2.
        """
        P = self.pressure
        P_0 = P.min()
        # continuity at P_3 gives T_2; at P_1 gives T_0
        T_2 = T_3 - (np.log(P_3 / P_1) / alpha_2) ** (1 / beta) \
            if P_3 > P_1 else T_3
        T_1 = T_2 + (np.log(P_1 / P_1) / alpha_2) ** (1 / beta)  # = T_2
        T_0 = T_1 - (np.log(P_1 / P_0) / alpha_1) ** (1 / beta)
        T = np.where(
            P < P_1, T_0 + (np.log(P / P_0) / alpha_1) ** (1 / beta),
            np.where(P < P_3,
                     T_2 + (np.log(np.maximum(P, P_1) / P_1) / alpha_2)
                     ** (1 / beta), T_3))
        return T

    def pt_madhu_seager_09_inversion(self, alpha_1, alpha_2, P_1, P_2, P_3,
                                     T_3, beta=0.5):
        """Madhu & Seager (2009) eq 2 with a thermal inversion layer."""
        P = self.pressure
        P_0 = P.min()
        T_2 = T_3 - (np.log(P_3 / P_2) / alpha_2) ** (1 / beta)
        T_1 = T_2 + (np.log(P_1 / P_2) / alpha_2) ** (1 / beta)
        T_0 = T_1 - (np.log(P_1 / P_0) / alpha_1) ** (1 / beta)
        zone1 = T_0 + (np.log(P / P_0) / alpha_1) ** (1 / beta)
        zone2 = T_2 + (np.abs(np.log(P / P_2)) / alpha_2) ** (1 / beta)
        return np.where(P < P_1, zone1, np.where(P < P_3, zone2, T_3))

    def pt_knots(self, P_knots, T_knots, interpolation='linear',
                 scipy_interpolate_kwargs=None):
        """T(P) spline/linear through (log P, T) knots."""
        from scipy.interpolate import PchipInterpolator, interp1d
        logp = np.log10(self.pressure)
        kx = np.log10(np.asarray(P_knots))
        order = np.argsort(kx)
        kx, ky = kx[order], np.asarray(T_knots)[order]
        if interpolation in ('brewster', 'pchip'):
            f = PchipInterpolator(kx, ky, extrapolate=True)
        else:
            f = interp1d(kx, ky, kind=interpolation,
                         fill_value='extrapolate',
                         **(scipy_interpolate_kwargs or {}))
        return np.asarray(f(logp))

    def pt_zj24(self, pressures, dTs, Tbottom):
        """ZJ24 gradient parameterization: monotone dT increments upward
        from the bottom temperature at log-spaced nodes."""
        nodes = np.log10(np.asarray(pressures))
        Ts = [Tbottom]
        for dT in dTs[::-1]:
            Ts.insert(0, Ts[0] - abs(dT))
        from scipy.interpolate import PchipInterpolator
        f = PchipInterpolator(nodes, np.asarray(Ts), extrapolate=True)
        return np.asarray(f(np.log10(self.pressure)))

    # -- chemistry parameterizations ----------------------------------------
    def chem_free(self, background=('H2', 'He'), background_ratio=0.837 /
                  0.163, **species):
        """Constant (or per-level) vmr per species; H2/He fill the rest
        (parameterizations.py:334-437)."""
        df = {'pressure': self.pressure}
        total = np.zeros(self.nlevel)
        for mol, vmr in species.items():
            if mol in ('temperature',):
                df[mol] = vmr
                continue
            arr = np.zeros(self.nlevel) + (10 ** vmr
                                           if np.all(np.asarray(vmr) <= 0)
                                           else vmr)
            df[mol] = arr
            total += arr
        fill = np.clip(1.0 - total, 0.0, 1.0)
        f1 = background_ratio / (1 + background_ratio)
        df[background[0]] = fill * f1
        df[background[1]] = fill * (1 - f1)
        return df

    def vmr_knots(self, P_knots, logvmr_knots):
        """log-vmr interpolated through pressure knots."""
        from scipy.interpolate import interp1d
        f = interp1d(np.log10(np.asarray(P_knots)),
                     np.asarray(logvmr_knots), kind='linear',
                     fill_value='extrapolate')
        return 10 ** f(np.log10(self.pressure))

    def vmr_gradient(self, logvmr_deep, logvmr_top, P_deep=1e2, P_top=1e-6):
        """log-linear vmr gradient between two pressures."""
        logp = np.log10(self.pressure)
        frac = np.clip((logp - np.log10(P_top))
                       / (np.log10(P_deep) - np.log10(P_top)), 0, 1)
        return 10 ** (logvmr_top + frac * (logvmr_deep - logvmr_top))

    # -- condensate Mie optics (needs load_cld_optical + mieff_dir) ----------
    def get_particle_dist(self, species, distribution,
                          lognorm_kwargs=None, hansen_kwargs=None):
        """Particle number-density distribution on the species' Mie
        radius grid (parameterizations.py:59-81): ``'lognorm'``
        (sigma = width in log10 radius, lograd = log10 median radius
        [cm]) or ``'hansen'`` (Hansen 1971: lograd = log10 effective
        radius a [cm], b = variance)."""
        radii = self.mie[species]['radii']
        if 'lognorm' in distribution:
            kw = lognorm_kwargs or {}
            sigma, lograd = kw['sigma'], kw['lograd']
            logr = np.log10(radii)
            return (1.0 / (sigma * np.sqrt(2.0 * np.pi))
                    * np.exp(-(logr - lograd) ** 2 / (2.0 * sigma ** 2)))
        if 'hansen' in distribution:
            kw = hansen_kwargs or {}
            a, b = 10.0 ** kw['lograd'], kw['b']
            return (radii ** ((1.0 - 3.0 * b) / b)
                    * np.exp(-radii / (a * b)))
        raise ValueError("distribution must be 'lognorm' or 'hansen'")

    def _dist_optics(self, condensate, ndz, distribution, lognorm_kwargs,
                     hansen_kwargs):
        """(opd [nw], w0, g0, wavenumber ascending) for a distribution
        integrated against the condensate's Mie tables."""
        from . import virga as vj
        if condensate not in self.mie:
            raise KeyError(f'{condensate} not preloaded — pass it via '
                           'load_cld_optical at construction')
        mie = self.mie[condensate]
        dist = self.get_particle_dist(condensate, distribution,
                                      lognorm_kwargs, hansen_kwargs)
        opd, w0, g0, wavenumber = vj.calc_optics_user_r_dist(
            mie['wave_um'], ndz, mie['radii'], dist, mie['qext'],
            mie['qscat'], mie['cos_qscat'])
        order = np.argsort(wavenumber)
        return opd[order], w0[order], g0[order], wavenumber[order]

    def cloud_flex_fsed(self, condensate, base_pressure, ndz, fsed,
                        distribution, lognorm_kwargs=None,
                        hansen_kwargs=None):
        """Cloud decaying upward from ``base_pressure`` at rate ``fsed``
        whose optics come from a user particle-size distribution
        integrated over the condensate's Mie tables
        (parameterizations.py:94-146)."""
        opd, w0, g0, wavenumber = self._dist_optics(
            condensate, ndz, distribution, lognorm_kwargs, hansen_kwargs)
        play = np.sqrt(self.pressure[1:] * self.pressure[:-1])
        # arbitrary height coordinate — fsed and ndz absorb the scale
        scale_h = 10.0
        z = np.linspace(100.0, 0.0, len(play))
        decay = np.where(play > base_pressure, 0.0,
                         np.exp(-fsed * z / scale_h))
        return picaso_format(opd, w0, g0, wavenumber, play,
                             p_bottom=base_pressure, p_decay=decay)

    def cloud_brewster_mie(self, condensate, distribution, decay_type,
                           lognorm_kwargs=None, hansen_kwargs=None,
                           slab_kwargs=None, deck_kwargs=None):
        """Mie-optics cloud (lognormal/hansen particle distribution)
        with a slab or deck vertical opd profile
        (parameterizations.py:148-199)."""
        opd, w0, g0, wavenumber = self._dist_optics(
            condensate, 1.0, distribution, lognorm_kwargs, hansen_kwargs)
        play = np.sqrt(self.pressure[1:] * self.pressure[:-1])
        if decay_type == 'slab':
            kw = slab_kwargs or {}
            ptop = kw['ptop']
            pbottom = ptop * 10.0 ** kw.get('dp', 0.005)
            total = kw.get('reference_tau', 1.0)
            inside = (play >= ptop) & (play <= pbottom)
            profile = np.where(inside, total / max(int(inside.sum()), 1),
                               0.0)
        elif decay_type == 'deck':
            kw = deck_kwargs or {}
            ptop, dp = kw['ptop'], kw.get('dp', 0.005)
            opd_max = kw.get('opd_max', 10.0)
            profile = opd_max * np.exp(
                -(np.log10(ptop) - np.log10(play)) / dp)
            profile = np.where(play >= ptop, opd_max, profile)
        else:
            raise ValueError("decay_type must be 'slab' or 'deck'")
        return picaso_format(opd, w0, g0, wavenumber, play,
                             opd_profile=profile)

    def cloud_virga(self, **virga_kwargs):
        """Run the full virga cloud solver from retrieval parameters
        (parameterizations.py:82-93).  ``kzz`` (scalar or [nlevel]) is
        written into the atmosphere profile; remaining kwargs go to
        ``inputs.virga`` (condensates, fsed, mh, ...)."""
        assert self.case is not None, 'call add_class(inputs) first'
        kzz = virga_kwargs.pop('kzz', None)
        if kzz is not None:
            # a column of the profile (a scalar fills it, as pandas does)
            prof = self.case.inputs['atmosphere']['profile']
            prof['kz'] = np.zeros(len(prof['pressure'])) + np.asarray(
                kzz, float)
        virga_kwargs.setdefault('directory', self.mieff_dir)
        self.case.virga(**virga_kwargs)
        return self.case.inputs['clouds']['profile']

    # -- chemistry parameterizations -----------------------------------------
    def chem_visscher(self, cto_absolute, log_mh, device='cuda'):
        """Chemically-consistent abundances from the Visscher grid
        (parameterizations.py:438-441), interpolated on ``device``."""
        assert self.case is not None, 'call add_class(inputs) first'
        try:
            self.case.chemeq_visscher_2121(cto_absolute, log_mh,
                                           device=device)
        except FileNotFoundError:
            # the 2121-point grids are a separate download; the bundled
            # 1060 grid covers the same (T, P) science range
            self.case.chemeq_visscher_1060(cto_absolute, log_mh,
                                           device=device)
        return self.case.inputs['atmosphere']['profile']

    # -- cloud parameterizations ---------------------------------------------
    def cloud_hard_grey(self, g0, w0, opd, p, dp):
        """Box cloud (delegates to inputs.clouds; justdoit.py:4126)."""
        assert self.case is not None, 'call add_class(inputs) first'
        self.case.clouds(g0=[g0], w0=[w0], opd=[opd], p=[p], dp=[dp])
        return self.case.inputs['clouds']['profile']

    def deck_decay(self, ptop, dp=0.005, opd_max=10.0, w0=0.0, g0=0.0):
        """Optically-thick deck with exponential upper decay
        (parameterizations.py:255-287)."""
        w = get_cld_input_grid()
        play = np.sqrt(self.pressure[1:] * self.pressure[:-1])
        opd_prof = opd_max * np.exp(-(np.log10(ptop) - np.log10(play))
                                    / dp)
        opd_prof = np.where(play >= ptop, opd_max, opd_prof)
        nl, nw = len(play), len(w)
        return {'opd': np.repeat(opd_prof, nw),
                'w0': np.zeros(nl * nw) + w0,
                'g0': np.zeros(nl * nw) + g0}

    def slab_decay(self, ptop, pbottom, total_opd, w0=0.9, g0=0.6,
                   alpha=0.0, reference_wave=1.0):
        """Slab cloud between two pressures with optional powerlaw
        wavelength dependence opd ~ (lambda/ref)^-alpha."""
        w = get_cld_input_grid()
        wave_um = 1e4 / w
        play = np.sqrt(self.pressure[1:] * self.pressure[:-1])
        inside = (play >= ptop) & (play <= pbottom)
        n_in = max(int(inside.sum()), 1)
        opd_layer = np.where(inside, total_opd / n_in, 0.0)
        scale = (wave_um / reference_wave) ** (-alpha)
        opd2d = opd_layer[:, None] * scale[None, :]
        nl, nw = len(play), len(w)
        return {'opd': opd2d.ravel(),
                'w0': np.zeros(nl * nw) + w0,
                'g0': np.zeros(nl * nw) + g0}

    def cloud_brewster_grey(self, decay_type, alpha, ssa, ptop, dp=0.005,
                            reference_tau=1.0, reference_wave=1.0, g0=0.0):
        """Grey/powerlaw cloud with deck or slab vertical structure."""
        if decay_type == 'deck':
            df = self.deck_decay(ptop, dp=dp, opd_max=reference_tau,
                                 w0=ssa, g0=g0)
        else:
            df = self.slab_decay(ptop, ptop * 10 ** dp, reference_tau,
                                 w0=ssa, g0=g0, alpha=alpha,
                                 reference_wave=reference_wave)
        return df


def picaso_format(opd, w0, g0, wavenumber_grid=None, pressure_grid=None,
                  p_bottom=None, p_top=None, p_decay=None,
                  opd_profile=None):
    """Flatten cloud arrays to the .cld table layout (a dict of columns)
    (parameterizations.py:672-752 / virga.picaso_format).

    ``opd`` may be [nlayer, nwno] (used as-is) or a 1D spectral shape
    [nwno] combined with a vertical structure the reference way:
    ``p_decay`` [nlayer] scales opd by p_decay/max(p_decay);
    ``opd_profile`` [nlayer] sets the absolute per-layer opd with the
    spectral shape normalized to its peak; ``p_top``/``p_bottom`` zero
    the cloud outside [p_top, p_bottom] (bars, on ``pressure_grid``).
    """
    opd = np.asarray(opd, float)
    w0 = np.asarray(w0, float)
    g0 = np.asarray(g0, float)
    if opd.ndim == 1:
        if pressure_grid is None:
            raise ValueError('1D opd needs pressure_grid')
        play = np.asarray(pressure_grid, float)
        if p_decay is not None:
            d = np.asarray(p_decay, float)
            vert = d / max(d.max(), 1e-300)
            opd2d = vert[:, None] * opd[None, :]
        elif opd_profile is not None:
            prof = np.asarray(opd_profile, float)
            opd2d = prof[:, None] * (opd / max(opd.max(), 1e-300))[None, :]
        elif p_top is not None or p_bottom is not None:
            opd2d = np.broadcast_to(opd[None, :],
                                    (len(play), len(opd))).copy()
        else:
            raise ValueError('1D opd needs p_top/p_decay/opd_profile')
        lo = p_top if p_top is not None else 0.0
        hi = p_bottom if p_bottom is not None else np.inf
        inside = (play >= lo) & (play <= hi)
        opd2d = np.where(inside[:, None], opd2d, 0.0)
        w0 = np.where(inside[:, None], w0[None, :], 0.0)
        g0 = np.where(inside[:, None], g0[None, :], 0.0)
        opd = opd2d
    nl, nw = opd.shape
    df = {'opd': opd.ravel(),
          'w0': np.broadcast_to(w0, opd.shape).ravel(),
          'g0': np.broadcast_to(g0, opd.shape).ravel()}
    if wavenumber_grid is not None:
        df['wavenumber'] = np.tile(np.asarray(wavenumber_grid), nl)
    if pressure_grid is not None:
        df['pressure'] = np.repeat(np.asarray(pressure_grid), nw)
    return df


def cloud_averaging(dfs, weights=None):
    """Weighted average of cloud tables (parameterizations.py:753): the
    first table's columns, opd/w0/g0 averaged."""
    weights = weights or [1.0 / len(dfs)] * len(dfs)
    out = {k: np.array(v) for k, v in dfs[0].items()}
    for col in ('opd', 'w0', 'g0'):
        out[col] = sum(wgt * np.asarray(df[col])
                       for wgt, df in zip(weights, dfs))
    return out
