"""``mindrec_tpu_torch/config.py`` against PyYAML and the JAX package's
``config.py``: its own parser gives ``yaml.safe_load_all``'s values on
the subset the config files use and raises on the rest; ``get_config``
gives the reference's config for the same command lines; the package's
copy of ``wide_deep_config.yaml`` parses to the reference file's
values."""

import math
from pathlib import Path

import pytest
import yaml

from mindrec_tpu import config as jconfig
from mindrec_tpu_torch import config

REPO = Path(__file__).resolve().parents[1]
REF_YAML = REPO / "examples" / "wide_deep_config.yaml"
PORT_YAML = REPO / "mindrec_tpu_torch" / "examples" / "wide_deep_config.yaml"

TEXTS = {
    "empty": "",
    "comment-only": "# nothing\n\n",
    "comment-then-start": "# c\n---\na: 1\n",
    "trailing-start": "a: 1\n---\n",
    "two-empty": "---\n---\n",
    "scalars": (
        "i: 42\nneg: -3\nplus: +7\nunders: 1_000\nzero: 0\nf: 0.00008\n"
        "g: 1024.0\nh: 3.\nd: .5\nexp: 1.0e-5\nexp_str: 1e-5\ninf: .inf\n"
        "ninf: -.Inf\nt: true\nT: True\ny: yes\noff: Off\nn: null\n"
        "tilde: ~\nempty:\nNul: NULL\n"),
    "strings": (
        "s: hello world  # trailing comment\nq: \"./data/criteo\"\n"
        "sq: 'it''s'\nesc: \"a\\\"b\\n\\tc\"\nurl: http://x.y/z\n"
        "hashy: a#b\nhome: ~/x\n"),
    "lists": ("l: [1024, 512, 256, 128]\nmixed: [1, 2.5, x, 'q', \"r\"]\n"
              "nested: [[1, 2], [], [true, ~]]\nempty: []\n"),
    "three-docs": REF_YAML.read_text(),
}


@pytest.mark.parametrize("name", list(TEXTS))
def test_parser_matches_pyyaml(name):
    text = TEXTS[name]
    want = list(yaml.safe_load_all(text))
    got = config.load_documents(text)
    assert repr(got) == repr(want)


def test_nan_matches_pyyaml():
    (got,) = config.load_documents("x: .nan\n")
    (want,) = yaml.safe_load_all("x: .nan\n")
    assert math.isnan(got["x"]) and math.isnan(want["x"])


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n", "- 1\n", "a: {b: 1}\n", "a: b: c\n", "a: &x 1\n",
    "a: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: 0x10\n", "a: 012\n",
    "a: 1:30\n", "%YAML 1.1\n---\na: 1\n", "a: 1\n...\n", "a: [1, 2\n",
    "a: 'open\n", "a: 1\na: 2\n", "--- a: 1\n",
])
def test_parser_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="yaml line"):
        config.load_documents(text)


def test_parse_yaml_needs_at_most_three_documents(tmp_path):
    p = tmp_path / "four.yaml"
    p.write_text("a: 1\n---\nb: 2\n---\nc: 3\n---\nd: 4\n")
    with pytest.raises(ValueError, match="at most 3"):
        config.parse_yaml(p)
    p.write_text("a: 1\n---\na: help\n")
    assert config.parse_yaml(p) == jconfig.parse_yaml(p) == (
        {"a": 1}, {"a": "help"}, {})


def test_package_yaml_copy_matches_the_reference_file():
    assert config.parse_yaml(PORT_YAML) == jconfig.parse_yaml(REF_YAML)
    assert config.parse_yaml(PORT_YAML) == tuple(
        yaml.safe_load_all(PORT_YAML.read_text()))


@pytest.mark.parametrize("argv", [
    [],
    ["--sparse", "1", "--vocab_size", "1000", "--emb_dim", "8"],
    ["--deep_layer_dim", "[16, 8]", "--l2_coef", "0.5", "--dataset_type",
     "packed", "--unknown", "x"],
    ["--dynamic_embedding", "true", "--keep_prob", "0.9", "--data_path",
     "/d"],
])
def test_get_config_matches_reference(argv):
    got = config.get_config(PORT_YAML, argv).to_dict()
    want = jconfig.get_config(REF_YAML, argv).to_dict()
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_choices_raise_as_the_reference():
    for mod, path in ((config, PORT_YAML), (jconfig, REF_YAML)):
        with pytest.raises(ValueError, match="not in choices"):
            mod.get_config(path, ["--dataset_type", "tfrecord"])
