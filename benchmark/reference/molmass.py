# Frozen copy of picaso_tpu_torch/molmass.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Molecular weights from main-isotope atomic masses.

Host (numpy) copy of ``picaso_tpu/molmass.py`` for the PyTorch port, which
must not import the JAX package.  Keep the two in step.

Replaces the vendored 2652-line periodic table of the reference
(the reference ``picaso/elements.py``), of which the framework only ever
uses one fact: the mass of each element's most-abundant isotope
(``atmsetup.py:334-338`` picks ``argmax(abundance)``).  We store exactly
that (atomic mass units, CODATA/AME2020), plus a parser for molecule strings
including the reference's isotopologue syntax (e.g. ``13C_16O2``).
"""

from __future__ import annotations

import re

__all__ = ['MAIN_ISOTOPE_MASS', 'ISOTOPE_MASS', 'molecular_weight']

# mass (u) of the most abundant isotope of each element
MAIN_ISOTOPE_MASS = {
    'H': 1.00782503207, 'D': 2.0141017778, 'He': 4.002603254,
    'Li': 7.01600455, 'Be': 9.0121822, 'B': 11.0093054, 'C': 12.0,
    'N': 14.0030740048, 'O': 15.9949146196, 'F': 18.99840322,
    'Ne': 19.9924401754, 'Na': 22.9897692809, 'Mg': 23.9850417,
    'Al': 26.98153863, 'Si': 27.9769265325, 'P': 30.97376163,
    'S': 31.972071, 'Cl': 34.96885268, 'Ar': 39.9623831225,
    'K': 38.96370668, 'Ca': 39.96259098, 'Sc': 44.9559119,
    'Ti': 47.9479463, 'V': 50.9439595, 'Cr': 51.9405075,
    'Mn': 54.9380451, 'Fe': 55.9349375, 'Co': 58.933195,
    'Ni': 57.9353429, 'Cu': 62.9295975, 'Zn': 63.9291422,
    'Ga': 68.9255736, 'Ge': 73.9211778, 'As': 74.9215965,
    'Se': 79.9165213, 'Br': 78.9183371, 'Kr': 83.911507,
    'Rb': 84.911789738, 'Sr': 87.9056121, 'Y': 88.9058483,
    'Zr': 89.9047044, 'Nb': 92.9063781, 'Mo': 97.9054082,
    'Ru': 101.9043493, 'Rh': 102.905504, 'Pd': 105.903486,
    'Ag': 106.905097, 'Cd': 113.9033585, 'In': 114.903878,
    'Sn': 119.9021947, 'Sb': 120.9038157, 'Te': 129.9062244,
    'I': 126.904473, 'Xe': 131.9041535, 'Cs': 132.905451933,
    'Ba': 137.9052472, 'La': 138.9063533, 'Ce': 139.9054387,
    'W': 183.9509312, 'Os': 191.9614807, 'Ir': 192.9629264,
    'Pt': 194.9647911, 'Au': 196.9665687, 'Hg': 201.970643,
    'Tl': 204.9744275, 'Pb': 207.9766521, 'Bi': 208.9803987,
    'U': 238.0507882,
    'e-': 5.48579909e-4,
}

# isotope masses used by the reference's isotopologue opacity sets
ISOTOPE_MASS = {
    ('H', 1): 1.00782503207, ('H', 2): 2.0141017778, ('H', 3): 3.0160492777,
    ('He', 3): 3.0160293191, ('He', 4): 4.002603254,
    ('C', 12): 12.0, ('C', 13): 13.0033548378, ('C', 14): 14.003241989,
    ('N', 14): 14.0030740048, ('N', 15): 15.0001088982,
    ('O', 16): 15.9949146196, ('O', 17): 16.99913170, ('O', 18): 17.9991610,
    ('S', 32): 31.972071, ('S', 33): 32.97145876, ('S', 34): 33.9678669,
    ('Si', 28): 27.9769265325, ('Si', 29): 28.9764947, ('Si', 30): 29.97377017,
    ('Cl', 35): 34.96885268, ('Cl', 37): 36.96590259,
    ('Ti', 46): 45.9526316, ('Ti', 47): 46.9517631, ('Ti', 48): 47.9479463,
    ('Ti', 49): 48.94787, ('Ti', 50): 49.9447912,
    ('Fe', 54): 53.9396105, ('Fe', 56): 55.9349375, ('Fe', 57): 56.935394,
}

_TOKEN = re.compile(r'([A-Z][a-z]?)(\d*)')
_ISO_TOKEN = re.compile(r'^(\d+)?([A-Z][a-z]?)(\d*)([+-])?$')


def _charge_stripped(name: str) -> str:
    # 'H3+' / 'H-' style ions: the charge doesn't change the mass at our
    # precision beyond the electron, which the reference also ignores.
    return name.rstrip('+-')


def molecular_weight(molecule: str) -> float:
    """Molecular weight (amu) of e.g. 'H2O', 'TiO', 'e-', or '13C_16O2'.

    Raises KeyError for unrecognized element symbols, mirroring the
    reference behaviour (atmsetup.py:196-210 catches and skips them).
    """
    if molecule == 'e-':
        return MAIN_ISOTOPE_MASS['e-']
    total = 0.0
    parts = molecule.split('_') if '_' in molecule else [molecule]
    for part in parts:
        part = _charge_stripped(part)
        if not part:
            continue
        m = _ISO_TOKEN.match(part)
        if m and m.group(1):  # isotope-prefixed token like '13C' or '16O2'
            iso, el, num, _ = m.groups()
            count = int(num) if num else 1
            mass = ISOTOPE_MASS.get((el, int(iso)))
            if mass is None:
                raise KeyError(f'unknown isotope {iso}{el}')
            total += mass * count
            continue
        consumed = 0
        for el, num in _TOKEN.findall(part):
            if not el:
                continue
            if el not in MAIN_ISOTOPE_MASS:
                raise KeyError(f'unknown element {el!r} in {molecule!r}')
            count = int(num) if num else 1
            total += MAIN_ISOTOPE_MASS[el] * count
            consumed += len(el) + len(num)
        if consumed != len(part):
            raise KeyError(f'could not parse molecule {molecule!r}')
    if total == 0.0:
        raise KeyError(f'could not parse molecule {molecule!r}')
    return total
