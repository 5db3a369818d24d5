"""ZeRO-1 (``cfg.shard_opt_state``: a ``ZeroRedundancyOptimizer`` over the
port's Adam) on 2 gloo ranks, on the CPU, at tests/test_parallel.py's
``_setup()`` geometry (tests/test_torch_ddp.py): two steps with the lr
changed between them (5e-5 after 1e-4, as an epoch boundary of the lr
plan changes it).

- bit-equal to replicated DDP: losses, parameters and BatchNorm buffers;
- each rank holds about half of the Adam moments' elements, together all
  of them;
- the checkpoint ``save_state`` writes (rank 0, after the consolidation)
  equals the replicated run's, and loads strictly into a single-process
  port whose Adam state then equals the replicated run's;
- against din_tpu's two single-device jitted steps with the same lr
  change, at test_parallel.py's tolerances (the ZeRO-1 case of
  ``test_zero1_opt_state_sharding_matches_replicated``): both steps'
  losses and the parameters after both steps.  The second loss is the
  tight one: with the weights of ``port_state`` seeds 0-3 it lies 5.0e-5,
  1.2e-4, 1.1e-4 and 4.4e-5 (relative) from din_tpu's, the first within
  3.6e-6 (train-mode BatchNorm's E[x^2] - E[x]^2 in float32 after one
  Adam step); this test holds seed 0's.
"""

import shutil

import numpy as np
import pytest
import torch

from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train.checkpoint import load_resume_state
from din_tpu_torch.train.optim import make_optimizer
from test_torch_ddp import (CPU, assert_like_jax, batch_of, jax_init,
                            jax_steps, joined, launch, port_cfg, port_state)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

LR2 = 5e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    cfg = port_cfg()
    batch = batch_of(cfg)
    state = port_state()
    common = dict(batch=batch, state=state, steps=2, lr2=LR2,
                  optimizer=True)
    cases = [dict(name="replicated", cfg={}, save=str(tmp / "rep.pth"),
                  **common),
             dict(name="zero", cfg={"shard_opt_state": True},
                  save=str(tmp / "zero.pth"), **common)]
    ranks = launch(2, cases)
    want = jax_steps(jax_init({}, batch, state), batch, steps=2, lr2=LR2)
    yield {"ranks": joined(ranks), "jax": want, "tmp": tmp, "cfg": cfg}
    shutil.rmtree(tmp)                     # the two checkpoints


def test_zero1_is_bit_equal_to_replicated(runs):
    for r in runs["ranks"]:
        assert r["zero"]["loss"] == r["replicated"]["loss"]
        rep, zero = r["replicated"]["state"], r["zero"]["state"]
        assert sorted(rep) == sorted(zero)
        for k in rep:
            assert torch.equal(rep[k], zero[k]), k


def test_each_rank_holds_about_half_of_the_moments(runs):
    ranks = runs["ranks"]
    total = ranks[0]["replicated"]["adam_elements"]
    shares = [r["zero"]["adam_elements"] for r in ranks]
    assert sum(shares) == total
    for s in shares:
        assert 0.35 * total <= s <= 0.65 * total, (shares, total)


def test_consolidated_file_equals_replicated_and_loads(runs):
    tmp = runs["tmp"]
    rep = torch.load(tmp / "rep.pth", weights_only=True)
    zero = torch.load(tmp / "zero.pth", weights_only=True)
    assert rep["epoch"] == zero["epoch"] == 1
    for k, v in rep["state_dict"].items():
        assert torch.equal(v, zero["state_dict"][k]), k
    assert sorted(rep["state_dict"]) == sorted(zero["state_dict"])
    assert not any(k.startswith("module.") for k in zero["state_dict"])
    ro, zo = rep["optimizer"], zero["optimizer"]
    assert ro["param_groups"] == zo["param_groups"]
    assert ro["param_groups"][0]["lr"] == LR2
    assert sorted(ro["state"]) == sorted(zo["state"])
    for i, s in ro["state"].items():
        for k, v in s.items():
            assert torch.equal(v, zo["state"][i][k]), (i, k)
    # strictly into one process
    model = build_model(runs["cfg"], device=CPU)
    optimizer = make_optimizer(runs["cfg"], model)
    assert load_resume_state(str(tmp / "zero.pth"), model, optimizer)[0] == 1
    got = optimizer.state_dict()
    for i, s in ro["state"].items():
        for k, v in s.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, rep["state_dict"][k]), k
    # rank 0's consolidated state is the file's
    cons = runs["ranks"][0]["zero"]["optimizer"]
    assert cons["param_groups"] == zo["param_groups"]
    assert runs["ranks"][1]["zero"]["optimizer"] is None


def test_zero1_matches_din_tpu(runs):
    losses, state = runs["jax"]
    ranks = [{"zero": {**r["zero"],
                       "loss": np.asarray(r["zero"]["loss"])}}
             for r in runs["ranks"]]
    assert_like_jax(ranks, losses, state, "zero")
