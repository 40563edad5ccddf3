"""TOML reading/writing (copy of sisr_tpu's ``utils/toml_io.py``).

The environment ships ``tomllib`` (read-only); the writer below covers the subset of TOML the
framework emits (nested tables, strings, numbers, bools, lists).  ``None`` values are skipped on
write (TOML has no null), matching the behaviour of the ``toml`` package used by the reference.
"""
from collections import defaultdict
import tomllib


def load(path):
    """Load a TOML file into a plain dict."""
    with open(path, 'rb') as f:
        return tomllib.load(f)


def _format_value(value):
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, str):
        escaped = value.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')
        return '"%s"' % escaped
    if isinstance(value, float):
        if value != value:  # nan
            return 'nan'
        if value in (float('inf'), float('-inf')):
            return 'inf' if value > 0 else '-inf'
        text = repr(value)
        return text if ('.' in text or 'e' in text or 'E' in text) else text + '.0'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, (list, tuple)):
        return '[ %s ]' % ', '.join(_format_value(v) for v in value if v is not None)
    raise TypeError('Cannot serialize %r to TOML' % (value,))


def _key_txt(key):
    bare = key.replace('_', '').replace('-', '')
    return key if (bare.isalnum() and bare.isascii()) else '"%s"' % key


def _dump_table(table, prefix, lines):
    scalars = {k: v for k, v in table.items() if not isinstance(v, dict) and v is not None}
    subtables = {k: v for k, v in table.items() if isinstance(v, dict)}

    if prefix and (scalars or not subtables):
        lines.append('[%s]' % prefix)
    for key, value in scalars.items():
        lines.append('%s = %s' % (_key_txt(key), _format_value(value)))
    if scalars:
        lines.append('')
    for key, value in subtables.items():
        sub_prefix = ('%s.%s' % (prefix, _key_txt(key))) if prefix else _key_txt(key)
        _dump_table(value, sub_prefix, lines)


def dumps(data):
    """Serialize a (possibly nested) dict to TOML text.  ``None`` values are skipped."""
    lines = []
    _dump_table(dict(data), '', lines)
    return '\n'.join(lines).rstrip() + '\n'


def dump(data, fileobj):
    text = dumps(data)
    if hasattr(fileobj, 'write'):
        fileobj.write(text)
    else:
        with open(fileobj, 'w') as f:
            f.write(text)
    return text


def convert_default_none_dict(in_dict):
    """A copy of ``in_dict`` (and of every nested dict) in which missing keys read as
    ``None`` (ref: Code/sr_tools/helper_functions.py:141-158)."""
    out = defaultdict(lambda: None, in_dict)
    for key, value in out.items():
        if type(value) == dict:
            out[key] = convert_default_none_dict(value)
    return out
