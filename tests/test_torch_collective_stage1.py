"""The port's Collective Activity stage 1 (``BasenetCollective`` on
ResNet-18) against the JAX package, on the CPU, with the helpers, geometry
and tolerances of tests/test_torch_collective.py.  The Basenet's ResNet-18
stage 1 is ``collective_stage1().replace(backbone="res18",
emb_features=512)`` (the preset is Inception-v3); it trains and evaluates
every frame, so its batch has per-frame actor counts (7, 5, 9 in the third
clip) and per-frame activities and actions.
"""

import pytest

from test_torch_collective import (_setup, check_padded_actors,
                                   check_predictor, check_train_step)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def basenet():
    return _setup("collective_stage1", 1, backbone="res18", emb_features=512)


def test_basenet_predictor_matches_jax(basenet):
    check_predictor(basenet, "basenet")


def test_basenet_padded_actors_do_not_change_the_answer(basenet):
    check_padded_actors(basenet, "basenet")


def test_basenet_one_train_step_matches_jax(basenet):
    check_train_step(basenet, "basenet", jit=True)
