"""Tests of the BaseModel parameter registry (reference parity).

Mirrors the reference's ``TestBaseModelFunctions``
(``test/test_models.py:20-77``) using ABCModel as the representative.
"""

import numpy as np
import pytest

from rrmpg_jax.models import ABCModel
from rrmpg_jax.models.basemodel import BaseModel


@pytest.fixture
def model():
    return ABCModel()


PARAM_NAMES = ['a', 'b', 'c']
DEFAULT_BOUNDS = {'a': (0, 1), 'b': (0, 1), 'c': (0, 1)}
DTYPE = np.dtype([('a', np.float64), ('b', np.float64), ('c', np.float64)])


def test_get_parameter_names(model):
    assert model.get_parameter_names() == PARAM_NAMES


def test_get_params(model):
    params = model.get_params()
    for param in PARAM_NAMES:
        assert param in params


def test_get_default_bounds(model):
    assert model.get_default_bounds() == DEFAULT_BOUNDS


def test_get_dtype(model):
    assert model.get_dtype() == DTYPE


def test_random_params_in_default_bounds(model):
    params = model.get_random_params()
    for p in PARAM_NAMES:
        low, high = DEFAULT_BOUNDS[p]
        assert low <= params[p][0] <= high


def test_abc_random_params_constraint(model):
    # ABC-specific: b <= 1 - a (reference rrmpg/models/abcmodel.py:96-101)
    params = model.get_random_params(num=100)
    assert np.all(params['b'] <= 1 - params['a'])


def test_get_multiple_random_param_sets(model):
    params = model.get_random_params(num=24)
    assert params.size == 24


def test_set_params_dict_roundtrip(model):
    rand_params = model.get_random_params()
    params = {p: rand_params[p][0] for p in PARAM_NAMES}
    model.set_params(params)
    assert params == model.get_params()


def test_set_params_structured_array(model):
    rand_params = model.get_random_params(num=3)
    model.set_params(rand_params)
    assert model.a == rand_params['a'][0]


def test_set_params_np_void(model):
    rand_params = model.get_random_params(num=3)
    model.set_params(rand_params[1])
    assert model.a == rand_params['a'][1]


def test_set_params_unknown_name_raises(model):
    with pytest.raises(AttributeError):
        model.set_params({'not_a_param': 1.0})


def test_set_params_non_numerical_raises(model):
    with pytest.raises(ValueError):
        model.set_params({'a': 'high'})


def test_set_params_wrong_dtype_raises(model):
    with pytest.raises(TypeError):
        model.set_params(np.zeros(1, dtype=np.dtype([('z', np.float64)])))


def test_missing_params_on_init_raises():
    with pytest.raises(AttributeError):
        ABCModel(params={'a': 0.5})


def test_model_subclass_of_basemodel(model):
    assert issubclass(model.__class__, BaseModel)


def test_sample_params_device_side(model):
    import jax
    sampled = model.sample_params(jax.random.PRNGKey(0), 17)
    assert set(sampled.keys()) == set(PARAM_NAMES)
    for p in PARAM_NAMES:
        low, high = DEFAULT_BOUNDS[p]
        assert sampled[p].shape == (17,)
        assert np.all(np.asarray(sampled[p]) >= low)
        assert np.all(np.asarray(sampled[p]) <= high)
