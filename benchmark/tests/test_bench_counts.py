"""The roofline's counts: exact at a fixed tiny shape, linear in the
number of wavenumbers."""

import pytest

from benchmark.reference import counts

# (method, stream, reflected, thermal, nlayer, nang)
SHAPES = [('toon', 2, True, True, 4, 5), ('toon', 2, True, False, 4, 36),
          ('sh', 4, True, True, 4, 5), ('sh', 4, True, False, 4, 36)]


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_rt_ops_linear_in_width(shape):
    method, stream, refl, therm, nlayer, nang = shape
    direct = {n: counts._count_rt(method, stream, refl, therm, nlayer, nang,
                                  n, counts.toon.ScatteringControls(), ())
              for n in (16, 32, 48, 80)}
    per_col = direct[32] - direct[16]
    assert per_col > 0 and per_col % 16 == 0
    for n, ops in direct.items():
        assert ops == direct[16] + per_col // 16 * (n - 16)
        assert counts.rt_ops(method, stream, refl, therm, nlayer, nang,
                             n) == ops


EXACT_TOON = 85824
EXACT_SH4 = 163516


def test_rt_ops_exact_at_a_tiny_shape():
    # Toon, reflected and thermal, 4 layers, 5 angles, 16 wavenumbers:
    # the count of this package's frozen RT, pinned so that an edit of it
    # shows
    assert counts.rt_ops('toon', 2, True, True, 4, 5, 16) == EXACT_TOON
    assert counts.rt_ops('sh', 4, True, False, 4, 5, 16) == EXACT_SH4


@pytest.mark.parametrize('table,element,params', [
    ('float32', 4, 0), ('int16', 2, 8)])
def test_gather_bytes_exact_at_the_table_element(table, element, params):
    # K1 reads 4 B float32 rows; K8 2 B int16 rows and its 8 B of
    # qparams (a float32 scale and offset); the rest is the same
    assert counts.gather_bytes(73, 16, 1000, 90, table) == (
        73 * 16 * 1000 * element + params + 4 * 90 * 8 + 16 * 90 * 4
        + 90 * 1000 * 4)


def test_bytes_exact_and_linear():
    assert counts.gather_bytes(73, 16, 1000, 90) == (
        73 * 16 * 1000 * 4 + 4 * 90 * 8 + 16 * 90 * 4 + 90 * 1000 * 4)
    assert counts.rt_bytes(90, 1000, 5, True, True) == (
        6 * 90 * 1000 * 4 + 1000 * 4 + (1000 * 4 + 5 * 1000 * 4)
        + (91 * 1000 * 4 + 5 * 1000 * 4))
    for fn in (lambda n: counts.gather_bytes(73, 16, n, 90),
               lambda n: counts.rt_bytes(90, n, 36, True, False)):
        assert fn(3000) - fn(2000) == fn(2000) - fn(1000)


def test_bound_takes_the_larger_term():
    peaks = {'f32_ops_per_s': 67e12, 'bytes_per_s': 3.35e12}
    assert counts.bound_s(67e9, 1e6, peaks) == (1e-3, 'operations')
    assert counts.bound_s(1.0, 3.35e9, peaks) == (1e-3, 'bytes')
