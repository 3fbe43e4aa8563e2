"""``correct``: what the window produced against the plain reference.

Each sampled spectrum (drawn from the seed among the finished requests)
is worked out again by the request kind's reference (for ``disk``,
:func:`benchmark.reference.spectrum.spectrum` of its one scene) from the
raw inputs, in float64, and each output kind gives five numbers, each
the worst over the sample:

* ``<output>_peak_gap``, ``<output>_p999_gap``: the widest gap over the
  spectrum and its 99.9th percentile over wavenumbers, as a share of the
  spectrum's largest magnitude;
* ``<output>_median_rel``, ``<output>_p99_rel``, ``<output>_p999_rel``:
  the median, 99th and 99.9th percentiles over wavenumbers of the
  relative gap, the reference's magnitude floored at 1e-9 of its largest.

The widest relative gap at each wavenumber was tried first and left out:
float32's own rounding near the solvers' resonances spikes it by 1e-3 and
more, within a few times of the control's.  ``limits/<cell>.json`` names
the numbers compared, each with its limit; the others are readings."""

from __future__ import annotations

import numpy as np

from ..reference import spectrum as ref

SHORT = {'albedo': 'albedo', 'thermal': 'thermal',
         'transit_depth': 'transit'}


# the numbers of one output, in the order gaps_of gives them
NUMBERS = ('peak_gap', 'median_rel', 'p99_rel', 'p999_rel', 'p999_gap')


def gaps_of(got, want):
    """(peak gap, median, 99th and 99.9th percentile relative gap, 99.9th
    percentile gap over the peak) of ``got`` from ``want``; all inf where
    ``got`` is not finite or not of ``want``'s shape."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return (float('inf'),) * len(NUMBERS)
    peak = np.abs(want).max() + 1e-300
    diff = np.abs(got - want)
    scale = np.maximum(np.abs(want), peak * 1e-9)
    median, p99, p999 = np.quantile(diff / scale, (0.5, 0.99, 0.999))
    return (float(diff.max() / peak), float(median), float(p99),
            float(p999), float(np.quantile(diff, 0.999) / peak))


def names(outputs):
    """The compared numbers' names of a cell's outputs."""
    return [f'{SHORT[k]}_{n}' for k in outputs for n in NUMBERS]


class Sampler:
    """A uniform sample of ``k`` finished requests, kept as they finish
    (reservoir sampling, the draws from the seed)."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.kept = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = item


def reference(kind, samples, table, planet, opts, outputs, device,
              precision='f64'):
    """The reference's spectra ({output: [nwno]}) of ``samples``, a list
    of (scenes, ...), each spectrum worked out by the request ``kind``
    (``harness/kind.py``) from its scenes, in ``precision``."""
    return [kind.reference(scenes, table, planet, opts, outputs, device,
                           precision)
            for scenes, *_ in samples]


def compare(gots, wants, outputs):
    """{number name: widest gap} of the spectra ``gots`` from ``wants``
    (lists of {output: [nwno]}), the worst over the list."""
    gaps = dict.fromkeys(names(outputs), 0.0)
    for got, want in zip(gots, wants):
        for k in outputs:
            for key, v in zip(names((k,)), gaps_of(got[k], want[k])):
                gaps[key] = max(gaps[key], v)
    return gaps


def options(cfg):
    """The reference's RT options of a configuration."""
    rt = cfg['rt']
    return ref.Options(method=rt['method'], stream=rt['stream'],
                       delta_eddington=rt['delta_eddington'],
                       controls=ref.toon.ScatteringControls(**rt['controls']),
                       sh=tuple(sorted(rt.get('sh', {}).items())))
