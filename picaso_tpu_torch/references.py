"""Citation tooling: bibtex lookup of opacity/method references.

Copy of ``picaso_tpu/references.py`` for the PyTorch port, which must not
import the JAX package.  As there, a port of the reference
``references.py`` without the bibtexparser
dependency — a small self-contained bibtex entry parser reads the bundled
``references.bib`` + ``reference_list.json``.
"""

from __future__ import annotations

import json
import re

from .refdata import refdata_path

__all__ = ['References']


def _parse_bibtex(text):
    """Minimal bibtex parser: entries -> dict keyed by ID."""
    entries = {}
    for m in re.finditer(r'@(\w+)\s*\{\s*([^,\s]+)\s*,', text):
        kind, key = m.group(1), m.group(2)
        start = m.end()
        depth = 1
        i = m.start() + text[m.start():].index('{') + 1
        j = i
        while j < len(text) and depth > 0:
            if text[j] == '{':
                depth += 1
            elif text[j] == '}':
                depth -= 1
            j += 1
        body = text[i:j - 1]
        fields = {'ENTRYTYPE': kind, 'ID': key}
        for fm in re.finditer(
                r'(\w+)\s*=\s*(\{(?:[^{}]|\{[^{}]*\})*\}|"[^"]*"|\S+)\s*,?',
                body):
            val = fm.group(2).strip().strip(',')
            val = val.strip('{}').strip('"')
            fields[fm.group(1).lower()] = val
        entries[key] = fields
    return entries


class References:
    """Lookup of opacity / methodology citations (references.py:8-118)."""

    def __init__(self):
        with open(refdata_path('references', 'references.bib')) as f:
            self.bib_dict = _parse_bibtex(f.read())
        with open(refdata_path('references', 'reference_list.json')) as f:
            self.reflist = json.load(f)

    def get_opa(self, full_output=None, molecules=None):
        """bibtex entries for the opacity sources of a model run."""
        if molecules is None:
            molecules = []
        if full_output is not None:
            molecules = list(molecules) + [
                m for m in full_output.get('weights', {})]
        opas = self.reflist.get('opacities', {})
        bibs, rows = [], []
        for mol in molecules:
            entry = opas.get(mol)
            if entry is None:
                continue
            ids = entry if isinstance(entry, list) else [entry]
            for eid in ids:
                key = eid if isinstance(eid, str) else str(eid)
                if key in self.bib_dict:
                    bibs.append(self.bib_dict[key])
                    rows.append((mol, key))
        return rows, bibs

    def get_methods(self, keys=None):
        """bibtex entries for methodology papers."""
        methods = self.reflist.get('methods', self.reflist)
        out = []
        for name, eid in (methods.items()
                          if isinstance(methods, dict) else []):
            if keys is not None and name not in keys:
                continue
            ids = eid if isinstance(eid, list) else [eid]
            out += [self.bib_dict[i] for i in ids if i in self.bib_dict]
        return out

    def write_bib(self, entries, filename):
        with open(filename, 'w') as f:
            for e in entries:
                f.write(f"@{e.get('ENTRYTYPE', 'article')}{{{e['ID']},\n")
                for k, v in e.items():
                    if k in ('ENTRYTYPE', 'ID'):
                        continue
                    f.write(f'  {k} = {{{v}}},\n')
                f.write('}\n\n')
        return filename
