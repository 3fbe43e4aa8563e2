"""Photochemical kinetics coupling (needs the external ``photochem``
package, Fortran-backed).

Port of ``picaso_tpu/photochem.py`` (the reference ``photochem.py``
wrapper) onto the port's profiles, dicts of numpy columns (pressure in
bar, top first): flips them into photochem's bottom-up convention in
dyn/cm^2, drives ``find_steady_state`` warm-started from the previous
solution, and writes the steady-state mixing ratios back into a profile.
The package is optional and absent from both machines the repository runs
on; importing this module without it works, and using it raises a clear
error then.
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = ['EvoAtmosphereGasGiantPicaso', 'MockKinetics',
           'photochem_available', 'generate_photochem_rx_and_thermo_files']

# profile columns that are not gases
_NOT_GASES = ('pressure', 'temperature', 'kz')
# photochem solution entries that are not gases
_NOT_SPECIES = ('pressure', 'temperature', 'Kzz', 'alt')


def photochem_available():
    try:
        import photochem  # noqa: F401
        return True
    except ImportError:
        return False


def _require_photochem():
    try:
        from photochem.extensions.gasgiants import EvoAtmosphereGasGiant
        return EvoAtmosphereGasGiant
    except ImportError as err:
        raise ImportError(
            'Photochemical-kinetics climate runs need the optional '
            '`photochem` package (https://github.com/Nicholaswogan/'
            'photochem). Install it, or use the quench approximation '
            '(diseq_chem=True without chem_method=photochem).') from err


def _bottom_up(x):
    return np.asarray(x, dtype=float)[::-1].copy()


class EvoAtmosphereGasGiantPicaso:
    """Adapter between the port's profiles and photochem's gas-giant class
    (reference photochem.py:23-183 semantics)."""

    def __init__(self, *args, save_file=None, **kwargs):
        base = _require_photochem()
        self._pc = base(*args, **kwargs)
        self.gdat = self._pc.gdat
        self.save_file = save_file
        self.initial_guess = None
        if save_file is not None:
            # the file is an append-log of steady states (reference
            # photochem.py:172-180); warm-start from the NEWEST record,
            # as a top-down profile the reinitialize path reads
            sol = None
            try:
                with open(save_file, 'rb') as f:
                    while True:
                        try:
                            sol = pickle.load(f)
                        except EOFError:
                            break
            except FileNotFoundError:
                pass
            if isinstance(sol, dict):
                self.initial_guess = {k: np.asarray(v)[::-1].copy()
                                      for k, v in sol.items() if k != 'alt'}

    def initialize_to_climate_equilibrium_PT_picaso(
            self, df, Kzz_in, metallicity, CtoO,
            rainout_condensed_atoms=True):
        """Cold start from equilibrium at a profile (photochem.py:76-94):
        bottom-up, bar -> dyn/cm^2."""
        self._pc.initialize_to_climate_equilibrium_PT(
            _bottom_up(df['pressure']) * 1e6, _bottom_up(df['temperature']),
            _bottom_up(Kzz_in), metallicity, CtoO, rainout_condensed_atoms)

    def reinitialize_to_new_climate_PT_picaso(self, df_temp,
                                              df_comp_guess, Kzz_in):
        """Warm start from a previous steady state (photochem.py:95-131):
        the mixing ratios of ``df_comp_guess``, normalised, on the new
        climate (T, P)."""
        pc = self._pc
        species = set(getattr(pc.dat, 'species_names', [])
                      ) or set(df_comp_guess.keys())
        mix = {k: _bottom_up(df_comp_guess[k]) for k in df_comp_guess
               if k in species and k not in _NOT_GASES}
        tot = sum(mix.values())
        mix = {k: v / tot for k, v in mix.items()}
        pc.reinitialize_to_new_climate_PT(
            _bottom_up(df_temp['pressure']) * 1e6,
            _bottom_up(df_temp['temperature']), _bottom_up(Kzz_in), mix)

    def _with_solution(self, df, sol):
        """``df`` with the steady state's gases (top-down) put in."""
        out = {k: np.asarray(v) for k, v in df.items()}
        for key, vals in sol.items():
            if key not in _NOT_SPECIES:
                out[key] = np.asarray(vals)[::-1].copy()
        return out

    def add_concentrations_to_picaso_df(self, df):
        """The profile ``df`` with the current steady state put in,
        normalised (photochem.py:36-75)."""
        sol = self._pc.return_atmosphere_climate_grid()
        press_dyn = _bottom_up(df['pressure']) * 1e6
        if not np.all(np.isclose(press_dyn, self.gdat.P_clima_grid)):
            raise ValueError('profile pressures do not match the photochem '
                             'climate grid')
        out = self._with_solution(df, sol)
        gases = [c for c in out if c not in _NOT_GASES]
        tot = sum(np.asarray(out[c], dtype=float) for c in gases)
        for c in gases:
            out[c] = np.asarray(out[c], dtype=float) / tot
        return out

    def run_for_picaso(self, df, log10metallicity, CtoO, Kzz,
                       df_comp_guess=None, rainout_condensed_atoms=True):
        """Steady-state kinetics on the climate grid (photochem.py:132-183).

        ``df`` is the top-down profile (``inputs['atmosphere']['profile']``).
        A previous steady state as ``df_comp_guess`` warm-starts the solve
        (the reinitialize path); otherwise it starts from equilibrium at
        the metallicity and C/O.  Each steady state is appended to the
        save file.  Returns the profile with the steady-state gases."""
        pc = self._pc
        if df_comp_guess is None:
            self.initialize_to_climate_equilibrium_PT_picaso(
                df, Kzz, 10.0 ** log10metallicity, CtoO,
                rainout_condensed_atoms)
        else:
            self.reinitialize_to_new_climate_PT_picaso(df, df_comp_guess,
                                                       Kzz)
        if not pc.find_steady_state():
            raise RuntimeError('photochem failed to find a steady state')
        sol = pc.return_atmosphere_climate_grid()
        if self.save_file is not None:
            with open(self.save_file, 'ab') as f:
                pickle.dump(sol, f)
        return self._with_solution(df, sol)



class MockKinetics:
    """A stand-in for :class:`EvoAtmosphereGasGiantPicaso` where photochem
    is not installed (the JAX package's examples and tests use one too):
    ``run_for_picaso`` on the dict profile freezes CH4 at its deepest
    (quenched) value, a signature an equilibrium update would erase, and
    keeps the other columns.  ``calls`` counts the solves, ``guesses``
    whether each was warm-started."""

    def __init__(self):
        self.calls = 0
        self.guesses = []

    def run_for_picaso(self, df, log10metallicity, CtoO, Kzz,
                       df_comp_guess=None, rainout_condensed_atoms=True):
        if len(Kzz) != len(df['pressure']):
            raise ValueError('MockKinetics: Kzz and the profile differ in '
                             'length')
        self.calls += 1
        self.guesses.append(df_comp_guess is not None)
        out = dict(df)
        if 'CH4' in out:
            ch4 = np.asarray(out['CH4'])
            out['CH4'] = np.full(len(ch4), float(ch4[-1]))
        return out

def generate_photochem_rx_and_thermo_files(*args, **kwargs):
    """Passthrough to photochem's file generator (photochem.py:185)."""
    _require_photochem()
    from photochem.extensions import gasgiants
    return gasgiants.generate_photochem_rx_and_thermo_files(*args,
                                                            **kwargs)
