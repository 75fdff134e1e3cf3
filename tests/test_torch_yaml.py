"""The port's YAML reader (``yaml_reader.safe_load``) against PyYAML's
``yaml.safe_load``, which this test alone imports (the port does not).

A hypothesis property dumps config-shaped trees with ``yaml.safe_dump``
under six option sets and reads each dump with both readers; a hand-written
corpus covers what a dump never writes (block scalars with every chomping,
anchors, aliases and merge keys, tags, timestamps, comments, document markers,
JSON in a ``.conf`` file); an error corpus holds the port to refusing, with
PyYAML's line and column, what PyYAML refuses. Values are compared by
``repr``, which tells 1 from 1.0 from True, keeps dict order, and shows nan
and recursive lists alike on both sides."""

import string

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.yaml_reader import YAMLError, safe_load

DUMP_OPTIONS = {
    "defaults": {},
    "unicode_unsorted": {"sort_keys": False, "allow_unicode": True},
    "width_20": {"width": 20},
    "flow": {"default_flow_style": True},
    "double_quoted": {"default_style": '"'},
    "indent_4": {"indent": 4},
}

# text that a naive reader gets wrong: IPA, YAML indicators, leading spaces,
# scalars that look like other types, line breaks
_CHARS = list(string.ascii_letters[:6]) + list("ɑɪʃŋæəθðé") + list(":#'\"-?[]{},&*!|>%@` \n\t.01")
_LOOKALIKES = ["yes", "no", "on", "off", "True", "1.0", "1e3", "1.0e+3", "0x1F", "010", "1:30",
               "null", "~", "", " lead", "trail ", "2020-01-01", "<<", "=", "a: b", "- a", "#c",
               ".inf", ".nan", "-", "?", "a #b", "'q'", '"d"', "x" * 90 + " b b b"]
TEXT = st.one_of(st.text(alphabet=st.sampled_from(_CHARS), max_size=24),
                 st.sampled_from(_LOOKALIKES))
SCALAR = st.one_of(TEXT, st.integers(min_value=-2**40, max_value=2**40),
                   st.floats(allow_nan=True, allow_infinity=True), st.booleans(), st.none())
TREE = st.recursive(
    SCALAR, lambda inner: st.one_of(st.lists(inner, max_size=4),
                                    st.dictionaries(TEXT, inner, max_size=4)),
    max_leaves=16)
CONFIG_TREE = st.dictionaries(TEXT, TREE, max_size=5)


def _load_both(text: str):
    """(PyYAML's result, the port's), each ("ok", repr) or ("error", ...)."""
    try:
        want = ("ok", repr(yaml.safe_load(text)))
    except yaml.YAMLError as exc:
        want = ("error", getattr(exc, "problem_mark", None))
    try:
        got = ("ok", repr(safe_load(text)))
    except YAMLError as exc:
        got = ("error", exc)
    return want, got


@pytest.mark.parametrize("options", list(DUMP_OPTIONS), ids=list(DUMP_OPTIONS))
@settings(max_examples=200, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(tree=CONFIG_TREE)
def test_safe_dump_of_a_config_tree_reads_as_safe_load_reads_it(options, tree):
    text = yaml.safe_dump(tree, **DUMP_OPTIONS[options])
    want, got = _load_both(text)
    assert want[0] == "ok" and got == want, text


CORPUS = {
    "block_sequence_at_the_key_indent": "ipa:\n- a\n- \"\\u0251\"\nb: 1\n",
    "nested_blocks": "a:\n  b:\n    c: 1\n  d: [1, 2]\ne:\n  - f: g\n    h: i\n  - - j\n    - k\n",
    "literal_clip_strip_keep": "c: |\n  a\n  b\n\n\ns: |-\n  a\n  b\n\n\nk: |+\n  a\n  b\n\n\nz: 1\n",
    "folded_clip_strip_keep": "c: >\n  a\n  b\n\n  c\n   d\ns: >-\n  a\n  b\n\nk: >+\n  a\n\n\n",
    "indentation_indicator": "a: |2\n    four\n   three\nb: >1-\n  x\n",
    "block_scalar_with_comment": "a: | # comment\n  text\n",
    "anchors_aliases_merge": ("base: &b {x: 1, y: 2}\nmore: &m\n  z: 3\n"
                              "d:\n  <<: [*b, *m]\n  y: 9\nl: &l [1, 2]\nm: *l\n"),
    "merge_order": "a: &a {k: 1, j: 2}\nb:\n  j: 0\n  <<: *a\n",
    "recursive_alias": "r: &r [1, *r]\n",
    "tags": ("s: !!str 1\ni: !!int '7'\nf: !!float 1\nb: !!bool yes\nn: !!null ''\n"
             "m: !!map {a: 1}\nq: !!seq [a]\nx: !!binary aGVsbG8=\ne: !!str\n"
             "v: !<tag:yaml.org,2002:str> 5\n"),
    "tag_directive": "%TAG !e! tag:yaml.org,2002:\n---\na: !e!int '12'\n",
    "timestamps": ("d: 2020-01-01\nt: 2001-12-14t21:59:43.10-05:00\ns: 2001-12-14 21:59:43.10\n"
                   "z: 2001-12-15T02:59:43.1Z\nx: !!timestamp 2020-1-2\n"),
    "comments": "# head\na: b#c  # tail\nd: 'e # f' # g\n# end\n",
    "document_markers": "%YAML 1.1\n--- # the document\na: b\n...\n",
    "empty_document": "---\n...\n",
    "only_comments": "# nothing here\n",
    "empty": "",
    "plain_folding": "a: a long plain\n  scalar over\n\n  three lines\nb: x\n",
    "single_quoted_folding": "a: 'it''s\n\n  folded  \n  here'\n",
    "double_quoted_escapes": ('a: "\\0\\a\\b\\t\\n\\v\\f\\r\\e\\ \\"\\/\\\\\\N\\_\\L\\P'
                              '\\x41\\u00e9\\U0001F600"\n'),
    "double_quoted_continuation": 'a: "one \\\n  two\n\n  three"\n',
    "flow_over_lines": "a: [1,\n  {b: c,\n   d: [e, f]},\n  'g']\nh: {i, j: }\n",
    "flow_pairs_and_keys": "- [a: 1, ? b : 2, c]\n- {? d, e: f}\n",
    "explicit_keys": "? a\n: 1\n? b c\n: 2\n? |\n  block key\n: 3\n",
    "scalar_keys": "1: a\n1.5: b\nyes: c\n~: d\n2020-01-01: e\n'1': f\n",
    "duplicate_keys": "a: 1\nb: 2\na: 3\n",
    "empty_values": "a:\nb: []\nc: {}\nd: ''\ne: ~\nf: !!str\n",
    "numbers": ("i: [0, -0, +1, 010, 0o17, 0x1F, 0b101, 1_000, 1:30, -1:30]\n"
                "f: [1.5, .5, -.5, 1e3, 1.0e3, 1.0e+3, 1_0.5, 1:30.5, .inf, -.Inf, .NaN]\n"),
    "bools_nulls": "b: [yes, No, ON, off, TRUE, false, y, n]\nn: [null, Null, NULL, ~, nul]\n",
    "bom_and_crlf": "\ufeffa: 1\r\nb:\r\n- c\r\n",
    "indented_root_sequence": "  - a\n  - b\n",
    "config_shaped": ("model:\n  encoder: {layers: 4, heads: 2}\n  dtype: bfloat16\ntext:\n"
                      "  symbols:\n    pad: _\n    letters: [a, b, \"\\u0283\"]\n"
                      "training:\n  vocoder_path: ../voc.npz\n  val_check_interval: 0.25\n"),
}


@pytest.mark.parametrize("name", list(CORPUS), ids=list(CORPUS))
def test_corpus_reads_as_safe_load_reads_it(name):
    want, got = _load_both(CORPUS[name])
    assert want[0] == "ok" and got == want


def test_a_json_document_in_a_conf_file_reads_as_safe_load_reads_it(tmp_path):
    """JAX reads every suffix but ``.json`` with ``yaml.safe_load``; a
    ``.conf`` file holding JSON reads as YAML reads it."""
    import json

    data = {"model": {"encoder": {"layers": 2}, "dtype": "float32"},
            "text": {"symbols": {"pad": "_", "ipa": ["ɑ", "ʃ", "a\"b", "c\\d", "\t"]}},
            "training": {"batch_size": 4, "val_check_interval": 0.5, "seed": None,
                         "early_stopping": {"metric": "none"}, "x": [1e-06, True, []]}}
    for indent in (None, 2):
        path = tmp_path / f"c{indent}.conf"
        path.write_text(json.dumps(data, indent=indent, ensure_ascii=indent is None))
        text = path.read_text()
        # YAML 1.1 reads 1e-06 (no dot) as a string, as the JAX loader does
        assert repr(safe_load(text)) == repr(yaml.safe_load(text))
        assert FastSpeech2Config.from_file(path).training.val_check_interval == 0.5


ERRORS = {
    "tab_indent": "a:\n\tb: 1\n",
    "unclosed_flow_sequence": "a: [1, 2\n",
    "unclosed_flow_mapping": "a: {b: 1\n",
    "two_documents": "a: 1\n---\nb: 2\n",
    "content_after_document_end": "a: 1\n...\nb: 2\n",
    "python_tuple": "a: !!python/tuple [1, 2]\n",
    "local_tag": "a: !local 1\n",
    "unclosed_quote": "a: 'unclosed\n",
    "undefined_alias": "a: *nope\n",
    "duplicate_anchor": "a: &x 1\nb: &x 2\n",
    "mapping_value_in_plain": "a: b: c\n",
    "bad_escape": 'a: "\\q"\n',
    "extra_bracket": "[a, b]]\n",
    "zero_indentation_indicator": "a: |0\n  x\n",
    "bad_indent": "key: value\n bad indent: 1\n",
    "sequence_then_mapping": "a:\n  - b\n  c: d\n",
    "yaml_2": "%YAML 2.0\n---\na\n",
    "str_tag_on_sequence": "!!str [a]\n",
    "unhashable_key": "? [a]\n: b\n",
    "merge_of_scalar": "<<: 1\n",
    "special_character": "a: \x01\n",
}


@pytest.mark.parametrize("name", list(ERRORS), ids=list(ERRORS))
def test_refuses_with_line_and_column_where_safe_load_refuses(name):
    text = ERRORS[name]
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(YAMLError) as info:
        safe_load(text)
    assert isinstance(info.value, ValueError)
    assert f"line {info.value.line}, column {info.value.column}" in str(info.value)
    want, _ = _load_both(text)
    if want[1] is not None:  # a marked error: the same place
        assert (info.value.line, info.value.column) == (want[1].line + 1, want[1].column + 1)
