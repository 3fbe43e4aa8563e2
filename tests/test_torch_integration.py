"""picaso_tpu_torch.integration_testing against
picaso_tpu.integration_testing: discovery, a run over a directory that
holds one script exiting 0 and one exiting 1, and the console entry
point; and the port's examples directory (a port of every JAX
example)."""

import os

from picaso_tpu import integration_testing as jit

from picaso_tpu_torch import integration_testing as tit

LEFT_OUT = set()


def scripts(tmp_path):
    (tmp_path / 'a_pass.py').write_text('print("fine")\n')
    (tmp_path / 'b_fail.py').write_text('raise SystemExit(1)\n')
    (tmp_path / 'notes.txt').write_text('not a script\n')
    return str(tmp_path)


def test_discover_matches_jax(tmp_path):
    d = scripts(tmp_path)
    for pattern in ('', 'pass', 'nothing'):
        assert tit.discover(pattern, d) == jit.discover(pattern, d)
    assert [os.path.basename(p) for p in tit.discover('', d)] == [
        'a_pass.py', 'b_fail.py']
    assert tit.discover('', str(tmp_path / 'missing')) == []


def test_run_all_matches_jax(tmp_path, capsys):
    d = scripts(tmp_path)
    got = tit.run_all(examples_dir=d, timeout=60)
    want = jit.run_all(examples_dir=d, timeout=60)
    assert {p: ok for p, (ok, _) in got.items()} == {
        p: ok for p, (ok, _) in want.items()} == {
        os.path.join(d, 'a_pass.py'): True,
        os.path.join(d, 'b_fail.py'): False}
    out = capsys.readouterr().out
    assert out.count('PASS a_pass.py') == 2
    assert out.count('FAIL b_fail.py') == 2


def test_main_and_the_port_examples(capsys):
    assert tit.main(['no_such_example']) == 1
    assert 'no examples matched' in capsys.readouterr().out
    ours = {os.path.basename(p) for p in tit.discover()}
    theirs = {os.path.basename(p) for p in jit.discover()}
    assert ours == theirs - LEFT_OUT
    for path in tit.discover():
        with open(path) as f:
            text = f.read()
        assert 'picaso_tpu_torch' in text
        assert 'import jax' not in text and 'from picaso_tpu ' not in text


def test_run_all_in_parallel_keeps_order_and_outputs(tmp_path, capsys):
    """``jobs`` examples at a time report as one at a time does, in the
    examples' order, and ``outputs`` keeps each one's exit code and
    standard output."""
    d = scripts(tmp_path)
    outputs = {}
    got = tit.run_all(examples_dir=d, timeout=60, jobs=2, outputs=outputs)
    assert list(got) == tit.discover('', d)
    assert {p: ok for p, (ok, _) in got.items()} == {
        os.path.join(d, 'a_pass.py'): True,
        os.path.join(d, 'b_fail.py'): False}
    assert [outputs[p].returncode for p in got] == [0, 1]
    assert outputs[os.path.join(d, 'a_pass.py')].stdout == 'fine\n'
    out = capsys.readouterr().out
    assert out.index('PASS a_pass.py') < out.index('FAIL b_fail.py')
