"""picaso_tpu_torch.references against picaso_tpu.references over the
bundled refdata/references files: the parsed bibtex, the opacity and
method lookups, and the written .bib."""

from picaso_tpu import references as jref

from picaso_tpu_torch import references as tref


def test_parse_bibtex_matches_jax():
    got, want = tref.References(), jref.References()
    assert got.bib_dict == want.bib_dict
    assert got.reflist == want.reflist
    assert len(got.bib_dict) > 10
    text = ('@article{a1, title={A {nested} title}, year=2020,\n'
            ' author="X and Y"}\n@misc{b2,note={n}}')
    assert tref._parse_bibtex(text) == jref._parse_bibtex(text)


def test_lookups_and_write_bib_match_jax(tmp_path):
    got, want = tref.References(), jref.References()
    full = {'weights': {'CO2': 1.0, 'NH3': 1.0}}
    for kw in (dict(molecules=['H2O', 'CH4']), dict(full_output=full),
               dict(full_output=full, molecules=['H2O'])):
        assert got.get_opa(**kw) == want.get_opa(**kw)
    rows, bibs = got.get_opa(molecules=['H2O', 'CH4'])
    assert len(bibs) >= 1
    assert got.get_methods() == want.get_methods()
    assert got.get_methods(keys=[]) == []
    a = got.write_bib(bibs, str(tmp_path / 'port.bib'))
    b = want.write_bib(bibs, str(tmp_path / 'jax.bib'))
    assert open(a).read() == open(b).read()
