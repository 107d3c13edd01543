"""The recorded JAX outputs in tests/torch_fixtures/ against a live run of
the JAX package: each fixture is made again by make_fixtures.py and must
equal the committed file.  Marked slow: every fixture compiles new JAX
shapes (several minutes on the CPU); the port's tests read the files."""
import importlib.util
import os

import pytest

from test_torch_common import FIXTURES, load_fixture


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_NAMES = sorted(f[:-5] for f in os.listdir(FIXTURES) if f.endswith(".json"))


@pytest.mark.slow
@pytest.mark.parametrize("name", _NAMES)
def test_fixture_matches_jax(name):
    assert _generator().record(name) == load_fixture(name)


def test_every_fixture_has_a_generator():
    """Each committed fixture is one the generator makes, and the other
    way round."""
    assert set(_generator().FIXTURES) == set(_NAMES)
