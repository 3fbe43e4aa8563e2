"""Minimal unit system (astropy-free).

Host (numpy) copy of ``picaso_tpu/units.py`` for the PyTorch port, which
must not import the JAX package.  Keep the two in step.

The reference API accepts astropy units in a handful of places
(``justdoit.gravity``, ``star(semi_major_unit=...)``); astropy is not part of
this environment, so we provide a tiny CGS-conversion shim covering every
unit string that appears in the reference call sites and notebooks.  The
shim is API-compatible in the common pattern::

    from picaso_tpu_torch import units as u
    case.gravity(gravity=25, gravity_unit=u.Unit('m/(s**2)'))

If astropy *is* installed we defer to it transparently, so user code written
against astropy keeps working.
"""

from __future__ import annotations

import re

try:  # pragma: no cover - exercised only when astropy exists
    import astropy.units as _astropy_units
    _HAVE_ASTROPY = True
except Exception:  # pragma: no cover
    _astropy_units = None
    _HAVE_ASTROPY = False


# conversion factor of each base unit string to its CGS equivalent
_TO_CGS = {
    # length -> cm
    'cm': 1.0, 'm': 100.0, 'km': 1e5, 'Rjup': 7.1492e9, 'R_jup': 7.1492e9,
    'Rearth': 6.378136e8, 'R_earth': 6.378136e8, 'Rsun': 6.957e10,
    'R_sun': 6.957e10, 'AU': 1.495978707e13, 'au': 1.495978707e13,
    'um': 1e-4, 'micron': 1e-4, 'nm': 1e-7, 'angstrom': 1e-8, 'AA': 1e-8,
    # mass -> g
    'g': 1.0, 'kg': 1e3, 'Mjup': 1.89818717e30, 'M_jup': 1.89818717e30,
    'Mearth': 5.97216787e27, 'M_earth': 5.97216787e27,
    'Msun': 1.98840987e33, 'M_sun': 1.98840987e33,
    # time -> s
    's': 1.0, 'hr': 3600.0, 'day': 86400.0, 'yr': 3.1557e7,
    # pressure -> dyne/cm2 (barye)
    'bar': 1e6, 'mbar': 1e3, 'Pa': 10.0, 'dyn/cm2': 1.0, 'barye': 1.0,
    # temperature
    'K': 1.0,
    # dimensionless
    '': 1.0, '1': 1.0,
    # energy -> erg
    'erg': 1.0, 'J': 1e7,
    # spectral
    'cm^(-1)': 1.0,
}

# composite units that show up in reference call sites
_COMPOSITE = {
    'm/s**2': 100.0, 'm/(s**2)': 100.0, 'm / (s2)': 100.0, 'm s-2': 100.0,
    'cm/s**2': 1.0, 'cm/(s**2)': 1.0, 'cm s-2': 1.0,
    'erg*cm^(-3)*s^(-1)': 1.0,
    'W/m2/um': 10.0,          # -> erg/s/cm^2/cm * 1e-4? kept for completeness
}


class Unit:
    """A unit with a scale factor to CGS."""

    __slots__ = ('name', 'cgs_factor')

    def __init__(self, name: str, cgs_factor: float | None = None):
        self.name = str(name)
        if cgs_factor is not None:
            self.cgs_factor = float(cgs_factor)
        else:
            self.cgs_factor = _parse(self.name)

    def to(self, other: 'Unit | str') -> float:
        """Conversion factor from this unit to ``other``."""
        other = Unit(other) if not isinstance(other, Unit) else other
        return self.cgs_factor / other.cgs_factor

    def __repr__(self):
        return f'Unit({self.name!r})'

    def __eq__(self, other):
        try:
            return abs(self.to(other) - 1.0) < 1e-12
        except Exception:
            return NotImplemented


def _parse(name: str) -> float:
    name = name.strip()
    if name in _TO_CGS:
        return _TO_CGS[name]
    if name in _COMPOSITE:
        return _COMPOSITE[name]
    if _HAVE_ASTROPY:  # fall back to astropy for exotic strings
        q = (1.0 * _astropy_units.Unit(name)).cgs
        return float(q.value)
    # handle simple "a/b" or "a/(b**2)" patterns
    m = re.fullmatch(r'([\w^()*-]+)\s*/\s*\(?([\w^*]+?)(?:\*\*|\^)?(\d*)\)?', name)
    if m:
        num, den, power = m.groups()
        p = int(power) if power else 1
        if num in _TO_CGS and den in _TO_CGS:
            return _TO_CGS[num] / _TO_CGS[den] ** p
    raise ValueError(f'Unknown unit string: {name!r}. '
                     'Install astropy or use one of: '
                     f'{sorted(_TO_CGS) + sorted(_COMPOSITE)}')


class Quantity:
    """value * unit, supporting .to(unit) like astropy."""

    __slots__ = ('value', 'unit')

    def __init__(self, value, unit: Unit):
        self.value = value
        self.unit = unit if isinstance(unit, Unit) else Unit(unit)

    def to(self, other) -> 'Quantity':
        other = other if isinstance(other, Unit) else Unit(other)
        return Quantity(self.value * self.unit.to(other), other)

    def __repr__(self):
        return f'{self.value} {self.unit.name}'


def to_cgs(value, unit) -> float:
    """Convert (value, unit) to the CGS value, accepting astropy or shim units."""
    if unit is None:
        return float(value)
    if _HAVE_ASTROPY and isinstance(unit, _astropy_units.UnitBase):
        return float((value * unit).cgs.value)
    if isinstance(unit, Unit):
        return float(value) * unit.cgs_factor
    return float(value) * Unit(str(unit)).cgs_factor
