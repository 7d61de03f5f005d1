"""``music_tpu_torch.core.config``'s ``Field``/``Schema`` against
``music_tpu.core.config``'s on the same configs: derived fields (the case
of ``tests/test_utils_cli.py::test_schema_derived_fields``), required
fields, typed defaults, int-for-float, validators, extra fields, and
loading a params file."""

import json

import pytest

from music_tpu.core import config as jconfig
from music_tpu_torch.core import config as tconfig
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)


def _schema(mod, **kw):
    return mod.Schema(
        fields={"num_filters": mod.Field(list), "hidden": mod.Field(int, 32),
                "lr": mod.Field(float, 1e-3), "name": mod.Field(str, None),
                "dropout": mod.Field(float, 0.5, validate=lambda v: 0 <= v < 1)},
        derived={"goal_out_size": lambda c: sum(c["num_filters"])}, **kw)


CASES = [
    {"num_filters": [100, 200]},
    {"num_filters": [1, 2, 3], "hidden": 8, "lr": 2},
    {"num_filters": [], "name": "x", "dropout": 0.0, "extra": {"a": 1}},
    {"hidden": 8},                                   # required field missing
    {"num_filters": [1], "hidden": "8"},              # wrong type
    {"num_filters": [1], "dropout": 1.5},             # validator refuses
    {"num_filters": (1, 2)},                          # a tuple is not a list
]


def _outcome(mod, raw, **kw):
    try:
        return _schema(mod, **kw).resolve(raw)
    except mod.ConfigError as e:
        return ("ConfigError", str(e))


@pytest.mark.parametrize("raw", CASES, ids=range(len(CASES)))
@pytest.mark.parametrize("allow_extra", [True, False])
def test_schema_resolve_matches_jax(raw, allow_extra):
    ours = _outcome(tconfig, raw, allow_extra=allow_extra)
    assert ours == _outcome(jconfig, raw, allow_extra=allow_extra)


def test_schema_derived_fields():
    """The JAX package's own case."""
    schema = tconfig.Schema(
        fields={"num_filters": tconfig.Field(list), "hidden": tconfig.Field(int, 32)},
        derived={"goal_out_size": lambda c: sum(c["num_filters"])},
    )
    cfg = schema.resolve({"num_filters": [100, 200]})
    assert cfg["goal_out_size"] == 300 and cfg["hidden"] == 32
    assert tconfig.Field(int).required and not tconfig.Field(int, 0).required
    assert type(_schema(tconfig).resolve({"num_filters": [], "lr": 2})["lr"]) is float


def test_schema_load_reads_the_repaired_dialect(tmp_path):
    path = tmp_path / "p.json"
    path.write_text('{\n  "num_filters": [4, 5]\n  "hidden": 3\n}\n')
    assert _schema(tconfig).load(path) == _schema(jconfig).load(path)
    path.write_text(json.dumps({"hidden": 3}))
    with pytest.raises(tconfig.ConfigError, match="num_filters"):
        _schema(tconfig).load(path)
