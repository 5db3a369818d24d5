"""Data-parallel training of the port on 2 and 4 gloo ranks (one process
each, ``parallel/launch.py``) against din_tpu's single-device jitted step
and the port's own single-process step, on the CPU.

The geometry is tests/test_parallel.py's ``_setup()``: DIN on ResNet-18
with live BatchNorm, 64x96 frames, T=2, 12 boxes, a global batch of 8,
float32, dropout 0; the DIN offset and affinity convs random, biases and
norm scales perturbed (``port_state``; din_tpu takes the same weights
through its reference-checkpoint import).
Each data rank takes its contiguous quarter or half of the batch, as
din_tpu's batch sharding does.

- Against din_tpu (test_parallel.py's tolerances): the loss (the sum of
  the ranks' shares) within rtol 1e-4, the parameters after the step within
  rtol 2e-3 and atol 5e-4, at world 2 and 4 (the whole step is one frame
  chunk, spanning every rank), and at world 4 with ``frame_chunk=8``, where
  each chunk spans two ranks (din_tpu's chunked scan as the reference).
  BatchNorm's running statistics are equal on every rank and within 1e-4
  of din_tpu's largest |value| per tensor.
- Against the port's single-process step at the same global batch, with
  the backbone in float64 (train-mode BatchNorm's E[x^2] - E[x]^2 cancels
  in float32 and its sums differ with the order): the all-reduced
  gradients within 1e-5 of the largest |g|, at world 2 and 4, and for a
  Collective stage-1 Basenet with padded (-1), class-weighted actions
  whose ranks hold unequal counts of valid actors (the loss denominators
  are global), and with ``grad_accum_steps=2`` (``no_sync()`` on the
  first micro-step) at world 2.
- Per-rank BatchNorm (each rank's statistics over its own frames, what
  ``DistributedDataParallel`` gives by default) would differ: the running
  statistics part between the ranks and from din_tpu's.

The rank functions (``rank_cases``) import no JAX; the parent computes
din_tpu's steps while the ranks run.
"""

import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from din_tpu_torch.config import Config
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.parallel.launch import run_ranks
from din_tpu_torch.parallel.mesh import make_mesh, use_mesh
from din_tpu_torch.train import engine
from din_tpu_torch.train.checkpoint import optimizer_state, save_state
from din_tpu_torch.train.optim import make_optimizer, set_learning_rate
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
THIS = __file__
GEOM = dict(training_stage=2, inference_module_name="dynamic_volleyball",
            data_path="synthetic", backbone="res18", image_size=(64, 96),
            out_size=(2, 3), emb_features=512, num_frames=2, num_boxes=12,
            num_features_boxes=32, num_features_gcn=32, lite_dim=None,
            ST_kernel_size=((3, 3),), sampling_ratio=[1], beta_factor=False,
            batch_size=8, compute_dtype="float32", train_backbone=True,
            train_dropout_prob=0.0)
# a Collective stage-1 Basenet on ResNet-18: per-frame actions padded with
# -1 past each clip's actor count, class-weighted
COLLECTIVE = dict(training_stage=1, backbone="res18", image_size=(64, 96),
                  out_size=(2, 3), emb_features=512, num_frames=2,
                  num_boxes=6, num_actions=5, num_activities=4,
                  num_features_boxes=32, compute_dtype="float32",
                  train_backbone=True, train_dropout_prob=0.0,
                  actions_weights=[[1.0, 2.0, 0.5, 3.0, 1.5]], batch_size=8)


def port_cfg(**kw):
    dataset = "collective" if kw.get("training_stage") == 1 else \
        "volleyball"
    base = COLLECTIVE if dataset == "collective" else GEOM
    return Config(dataset).replace(**dict(base, **kw))


def batch_of(cfg, n=8):
    """test_parallel.py's batch: the first ``n`` synthetic clips."""
    ds = SyntheticDataset(cfg, size=n)
    samples = [ds[i] for i in range(n)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def collective_batch():
    """8 clips of 2 frames whose first half holds more valid actors than
    the second, so that the ranks' valid action counts differ."""
    ds = SyntheticDataset(port_cfg(training_stage=1), size=64, seed=5,
                          is_training=False)
    order = sorted(range(64), key=lambda i: -int(ds[i]["bboxes_num"][0]))
    samples = [ds[i] for i in order[:4] + order[-4:]]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def build(cfg, state, exact=False):
    """The port's model of ``cfg`` on the CPU with ``state`` loaded; with
    ``exact`` its backbone in float64."""
    model = build_model(cfg, device=CPU)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    if exact:
        model.backbone.double()
    return model


def run_case(case: dict, mesh=None) -> dict:
    """One case's steps on this rank (``mesh``) or on one process: the
    rank's slice of the batch, the model of ``case["state"]``, one step
    (or ``steps``, the lr set to ``lr2`` before the second), the
    checkpoint ``save`` names, and what the tests read."""
    exact = case.get("exact", False)
    cfg = port_cfg(**case["cfg"], **(
        {"compute_dtype": "float64"} if exact else {}))
    batch = case["batch"]
    data = 1 if mesh is None else mesh.data
    n = batch["images"].shape[0] // data
    d = 0 if mesh is None else mesh.data_index
    local = to_device({k: v[d * n:(d + 1) * n] for k, v in batch.items()},
                      CPU)
    cfg = cfg.replace(batch_size=n)
    model = build(cfg, case["state"], exact)
    if mesh is not None and mesh.data_index:
        engine.seed_dropouts_for_rank(model, mesh.data_index)
    optimizer = make_optimizer(cfg, model, mesh)
    step_model = engine.wrap_model(model, mesh)
    if case.get("local_bn"):
        from din_tpu_torch.models import trunk
        saved, trunk.ChunkStatistics = trunk.ChunkStatistics, \
            lambda *a: None
    losses = []
    try:
        with use_mesh(mesh):
            for i in range(case.get("steps", 1)):
                if i and case.get("lr2"):
                    set_learning_rate(optimizer, case["lr2"])
                m = engine.train_step(step_model, optimizer, local, cfg)
                losses.append(float(m["loss"]))
    finally:
        if case.get("local_bn"):
            trunk.ChunkStatistics = saved
    out = {"loss": losses,
           "state": {k: v.clone() for k, v in model.state_dict().items()}}
    if case.get("grads"):
        out["grads"] = {k: p.grad.clone() for k, p in
                        model.named_parameters() if p.grad is not None}
    if case.get("save"):
        save_state(case["save"], 1, model, optimizer, mesh)
    if case.get("optimizer"):
        # every rank consolidates; rank 0's param groups (the moments are
        # read from the saved files)
        full = optimizer_state(optimizer, mesh)
        out["optimizer"] = None if full is None else \
            {"param_groups": full["param_groups"]}
        local_opt = getattr(optimizer, "optim", optimizer)
        out["adam_elements"] = sum(
            v.numel() for s in local_opt.state.values() for k, v in s.items()
            if k in ("exp_avg", "exp_avg_sq"))
    return out


def _digest(v: torch.Tensor) -> tuple:
    raw = v.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return str(v.dtype), tuple(v.shape), hashlib.blake2b(raw).hexdigest()


def rank_cases(cases):
    """On every rank: each case under the mesh of its config.  A tensor of
    ``state`` or ``grads`` that is bit-equal to rank 0's comes back as its
    place in ``same`` instead (``joined`` puts rank 0's there), so that
    the ranks' result files stay small."""
    import torch.distributed as dist

    out = {c["name"]: run_case(c, make_mesh(port_cfg(**c["cfg"])))
           for c in cases}
    digests = {(n, f, k): _digest(v) for n, o in out.items()
               for f in ("state", "grads") for k, v in o.get(f, {}).items()}
    ref = [digests]
    dist.broadcast_object_list(ref, src=0)
    if dist.get_rank():
        for (n, f, k), d in digests.items():
            if ref[0][n, f, k] == d:
                del out[n][f][k]
                out[n].setdefault("same", []).append((f, k))
    return out


def launch(world, cases):
    """``rank_cases`` on ``world`` ranks (4 torch threads in all), on a
    thread: (thread, results)."""
    got = {}

    def target():
        try:
            got["ranks"] = run_ranks(THIS + ":rank_cases", world,
                                     {"cases": cases}, device="cpu",
                                     threads=4 // world, timeout=240)
        except BaseException as e:       # raised again by the caller
            got["error"] = e

    t = threading.Thread(target=target)
    t.start()
    return t, got


def joined(launched):
    t, got = launched
    t.join(timeout=300)
    assert not t.is_alive(), "the ranks' launcher did not return"
    if "error" in got:
        raise got["error"]
    ranks = got["ranks"]
    for r in ranks[1:]:
        for name, o in r.items():
            for f, k in o.pop("same", []):
                o[f][k] = ranks[0][name][f][k]
    return ranks


# -- din_tpu's side (imported in the parent only) ---------------------------

def port_state(cfg_kw=None, seed=0) -> dict:
    """The port's model of ``cfg_kw`` as built, with the DIN offset and
    affinity convs random and its biases and norm scales perturbed (as
    tests/test_torch_train.py ``_perturb`` perturbs din_tpu's): a numpy
    state dict, made without JAX so that the ranks can start at once."""
    model = build_model(port_cfg(**(cfg_kw or {})), device=CPU)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if ".p_conv." in name or ".scale_conv." in name:
                p.copy_(0.05 * noise)
            elif name.endswith(".bias"):
                p.add_(0.05 * noise)
            elif name.endswith(".weight") and p.ndim == 1:
                p.mul_(1.0 + 0.1 * noise)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def jax_init(cfg_kw, batch, state):
    """din_tpu's model of ``cfg_kw`` with the weights of ``state`` (through
    din_tpu's own reference-checkpoint import into a zero-filled tree of
    its variables' shapes, every leaf replaced, checked by the way back):
    (jcfg, model, params, stats, the port's cfg, ``state``)."""
    import jax
    import jax.numpy as jnp

    from din_tpu.config import Config as JConfig
    from din_tpu.models.registry import build_model as jax_build_model
    from din_tpu.nn.ref_import import load_reference_checkpoint
    from din_tpu_torch.nn.ref_export import jax_params_to_state_dict

    jcfg = JConfig("volleyball").replace(folded_stem=False,
                                         **dict(GEOM, **cfg_kw))
    cfg = port_cfg(**cfg_kw)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda images, boxes: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, images, boxes, train=False),
        jnp.asarray(batch["images"]), jnp.asarray(batch["boxes"]))
    variables, skipped = load_reference_checkpoint(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        state, jcfg, verbose=False)
    assert not [k for k in skipped if k.startswith("(unapplied)")], skipped
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables.get("batch_stats", {}))
    back = jax_params_to_state_dict(params, cfg, stats)
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    return jcfg, jmodel, params, stats, cfg, state


def chunked(init, frame_chunk):
    """``init``'s weights under din_tpu's trunk scanning ``frame_chunk``
    frames at a time (the same variables)."""
    from din_tpu.models.registry import build_model as jax_build_model

    jcfg, _, params, stats, cfg, state = init
    jcfg = jcfg.replace(frame_chunk=frame_chunk)
    return (jcfg, jax_build_model(jcfg), params, stats,
            cfg.replace(frame_chunk=frame_chunk), state)


def jax_steps(init, batch, steps=1, lr2=None):
    """din_tpu's jitted single-device steps from ``init``: (losses, the
    port's state dict after them)."""
    import jax
    import jax.numpy as jnp

    from din_tpu.train.engine import TrainState, make_train_step
    from din_tpu.train.optim import make_optimizer as jax_make_optimizer
    from din_tpu.train.optim import set_learning_rate as jax_set_lr
    from din_tpu_torch.nn.ref_export import jax_params_to_state_dict

    jcfg, jmodel, params, stats, cfg, _ = init
    tx = jax_make_optimizer(jcfg, params)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(3))
    step = make_train_step(jmodel, jcfg, tx, frame0_labels=True,
                           has_bn=True, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    with jax.default_matmul_precision("highest"):
        for i in range(steps):
            if i and lr2:
                state = state.replace(
                    opt_state=jax_set_lr(state.opt_state, lr2))
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
    state = jax.device_get(state)
    return losses, {k: np.array(v) for k, v in jax_params_to_state_dict(
        state.params, cfg, state.batch_stats).items()}


def assert_like_jax(ranks, jax_losses, jax_state, case):
    """test_parallel.py's tolerances; the losses of the first
    ``len(jax_losses)`` steps; the statistics equal on every rank and,
    after one step, within 1e-4 of their largest |value| (after more, the
    statistics of a step follow parameters that differ by Adam's steps, and
    take test_parallel.py's tolerances as the parameters do)."""
    losses = np.sum([r[case]["loss"] for r in ranks], axis=0)
    np.testing.assert_allclose(losses[:len(jax_losses)], jax_losses,
                               rtol=1e-4)
    own = ranks[0][case]["state"]
    one_step = len(ranks[0][case]["loss"]) == 1
    n_stats = 0
    for k, w in jax_state.items():
        got = own[k].double().numpy()
        if k.endswith(("running_mean", "running_var")):
            for r in ranks[1:]:
                assert torch.equal(r[case]["state"][k], own[k]), (case, k)
            if one_step:
                assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), \
                    (case, k)
            else:
                np.testing.assert_allclose(got, w, rtol=2e-3, atol=5e-4,
                                           err_msg=f"{case} {k}")
            n_stats += 1
        elif k.endswith("num_batches_tracked"):
            continue
        else:
            np.testing.assert_allclose(got, w, rtol=2e-3, atol=5e-4,
                                       err_msg=f"{case} {k}")
    assert n_stats == 40                   # ResNet-18's 20 BatchNorms


def assert_grads_close(got, want, what):
    """The all-reduced gradients within 1e-5 of the largest |g|."""
    assert sorted(got) == sorted(want), what
    top = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        gap = float((got[k].double() - g.double()).abs().max())
        assert gap <= 1e-5 * top, (what, k, gap, top)


@pytest.fixture(scope="module")
def runs():
    """Both worlds' ranks and din_tpu's steps, computed side by side."""
    cfg = port_cfg()
    batch = batch_of(cfg)
    cbatch = collective_batch()
    state = port_state()
    cstate = build_model(port_cfg(training_stage=1), device=CPU).state_dict()
    w2 = [dict(name="plain", cfg={}, batch=batch, state=state),
          dict(name="exact", cfg={}, batch=batch, state=state, exact=True,
               grads=True),
          dict(name="collective", cfg={"training_stage": 1}, batch=cbatch,
               state=cstate, exact=True, grads=True),
          dict(name="local_bn", cfg={}, batch=batch, state=state,
               local_bn=True),
          dict(name="accum", cfg={"grad_accum_steps": 2}, batch=batch,
               state=state, exact=True, grads=True)]
    w4 = [dict(name="plain", cfg={}, batch=batch, state=state),
          dict(name="chunk8", cfg={"frame_chunk": 8}, batch=batch,
               state=state),
          dict(name="exact", cfg={}, batch=batch, state=state, exact=True,
               grads=True)]
    two, four = launch(2, w2), launch(4, w4)
    init = jax_init({}, batch, state)
    init8 = chunked(init, 8)
    # the references on threads beside the ranks (XLA's compiles and
    # torch's kernels release the interpreter)
    accum_batch = {k: v[[0, 1, 4, 5, 2, 3, 6, 7]]   # the ranks' m-th
                   for k, v in batch.items()}       # micro-batches together
    with ThreadPoolExecutor(3) as pool:
        jobs = {"jax": pool.submit(jax_steps, init, batch),
                "jax8": pool.submit(jax_steps, init8, batch),
                "single": pool.submit(lambda: [
                    run_case(dict(w2[1])), run_case(dict(w2[2])),
                    run_case(dict(w2[4], batch=accum_batch))])}
        out = {k: f.result() for k, f in jobs.items()}
    out["single"], out["single_collective"], out["single_accum"] = \
        out["single"]
    out[2], out[4] = joined(two), joined(four)
    out["cbatch"] = cbatch
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_matches_din_tpu(runs, world):
    assert_like_jax(runs[world], *runs["jax"], "plain")


def test_chunk_spanning_ranks_matches_din_tpu(runs):
    """frame_chunk=8 at world 4: 16 frames in two chunks, each spanning two
    ranks of 4 frames, its statistics reduced over those two."""
    assert_like_jax(runs[4], *runs["jax8"], "chunk8")


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduced_gradients_match_one_process(runs, world):
    ranks = runs[world]
    single = runs["single"]
    np.testing.assert_allclose(sum(r["exact"]["loss"][0] for r in ranks),
                               single["loss"][0], rtol=1e-6)
    for r in ranks:
        assert_grads_close(r["exact"]["grads"], single["grads"],
                           f"world {world}")
        for k, v in r["exact"]["state"].items():
            assert torch.equal(v, ranks[0]["exact"]["state"][k]), k


def test_accumulated_micro_steps_sync_once_and_match_one_process(runs):
    """``grad_accum_steps=2`` on 2 ranks: each rank's 4 clips in two
    micro-steps of 2 (the first under ``no_sync()``), each micro-step's 8
    frames one chunk over both ranks; the gradients those of one process's
    two micro-steps of the same 4 clips each (each rank splits its own
    batch, so micro-step m holds every rank's m-th slice)."""
    ranks, single = runs[2], runs["single_accum"]
    np.testing.assert_allclose(sum(r["accum"]["loss"][0] for r in ranks),
                               single["loss"][0], rtol=1e-6)
    for r in ranks:
        assert_grads_close(r["accum"]["grads"], single["grads"], "accum")


def test_padded_weighted_actions_use_global_denominators(runs):
    """Each rank's actions loss divides by the weight of every rank's
    valid actions: the shares add up to the one-process loss and the
    gradients to its gradients, although the ranks' counts differ."""
    bn = runs["cbatch"]["bboxes_num"][:, 0]
    assert bn[:4].sum() != bn[4:].sum(), bn
    ranks = runs[2]
    single = runs["single_collective"]
    np.testing.assert_allclose(
        sum(r["collective"]["loss"][0] for r in ranks),
        single["loss"][0], rtol=1e-6)
    for r in ranks:
        assert_grads_close(r["collective"]["grads"], single["grads"],
                           "collective")


def test_per_rank_batchnorm_would_differ(runs):
    """Without the reduced chunk statistics each rank normalises its own 8
    frames: the ranks' running statistics part, and part from din_tpu's
    by far more than the reduced ones do."""
    ranks = runs[2]
    _, want = runs["jax"]
    a, b = (r["local_bn"]["state"] for r in ranks)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert any(not torch.equal(a[k], b[k]) for k in stats)

    def worst(state):
        return max(float(np.abs(state[k].double().numpy() - want[k]).max()
                         / np.abs(want[k]).max()) for k in stats)
    reduced = worst(ranks[0]["plain"]["state"])
    assert reduced <= 1e-4
    assert worst(a) > 100 * max(reduced, 1e-7)


# -- pieces without ranks ----------------------------------------------------

def _fake_mesh(P, M=1, rank=0):
    from types import SimpleNamespace
    return SimpleNamespace(model=M, frame_parallel=M > 1,
                           model_index=rank % M, frame_size=P,
                           frame_index=rank, frame_group=None,
                           model_group=None)


@pytest.mark.parametrize("L,P,chunk,bn_live,mode", [
    (8, 2, None, True, "auto"),      # one chunk of 16 spanning both ranks
    (4, 4, 8, True, "auto"),         # two chunks, each over two ranks
    (20, 2, 5, True, "auto"),        # four whole chunks on each rank
    (20, 2, 8, True, "auto"),        # 8-frame chunks, one over both ranks
    (6, 4, 8, True, "auto"),         # ranks touching 1 or 2 chunks
    (20, 2, 8, False, "auto"),       # shard-local: 4 frames of each chunk
    (20, 2, 8, True, "on"),          # shard-local with live BatchNorm
    (20, 2, 5, False, "auto"),       # 5-frame chunks do not split over 2
])
def test_frame_plan_covers_every_chunk_once(L, P, chunk, bn_live, mode):
    """``FramePlan`` on every rank: the same number of rounds; each chunk in
    one round on every rank; the ranks' pieces of a chunk together its
    frames (din_tpu's packing: frame order, or every rank's own slice);
    ``order`` puts each rank's frames back in order."""
    from din_tpu_torch.models.trunk import FramePlan, auto_chunk

    F = P * L
    c = auto_chunk(F, 64, 96, chunk, True)
    plans = [FramePlan(_fake_mesh(P, rank=p), L, 64, 96, chunk, True,
                       bn_live, mode) for p in range(P)]
    assert len({len(pl.rounds) for pl in plans}) == 1
    assert all(pl.chunk == c and pl.num_chunks == F // c for pl in plans)
    frames, rounds_of = {}, {}
    for p, pl in enumerate(plans):
        taken = []
        for j, (pieces, done) in enumerate(pl.rounds):
            assert pieces, "a rank sits a round out"
            for k, s, e in pieces:
                assert k in done
                rounds_of.setdefault(k, set()).add(j)
                frames.setdefault(k, []).extend(p * L + i
                                                for i in range(s, e))
                taken += list(range(s, e))
        order = torch.arange(L) if pl.order is None else pl.order
        assert torch.equal(torch.tensor(taken)[order], torch.arange(L))
    assert sorted(frames) == list(range(F // c))
    shard_local = (mode == "on" or not bn_live) and c % P == 0
    for k, got in frames.items():
        assert len(rounds_of[k]) == 1
        if shard_local:
            cl = c // P
            want = [p * L + i for p in range(P)
                    for i in range(k * cl, (k + 1) * cl)]
        else:
            want = list(range(k * c, (k + 1) * c))
        assert sorted(got) == want


def test_frame_plan_needs_the_frames_to_split_over_a_model_group():
    from din_tpu_torch.models.trunk import FramePlan

    plan = FramePlan(_fake_mesh(4, M=2, rank=3), 10, 64, 96, None, True,
                     False)
    assert (plan.start, plan.stop) == (5, 10) and plan.gather is not None
    with pytest.raises(ValueError, match="do not split"):
        FramePlan(_fake_mesh(4, M=4, rank=0), 10, 64, 96, None, True, False)


def test_mesh_of_one_process_and_frame_axes_match_din_tpu():
    from din_tpu.config import Config as JConfig
    from din_tpu.parallel.mesh import frame_axes as jax_frame_axes
    from din_tpu_torch.parallel.mesh import current_mesh, frame_axes

    mesh = make_mesh(port_cfg(mesh_shape={"data": 1}))
    assert (mesh.data, mesh.model, mesh.size, mesh.rank) == (1, 1, 1, 0)
    assert mesh.data_group is None and mesh.agree(True) and \
        not mesh.agree(False)
    x = np.arange(3.0)
    assert mesh.host_sum(x) is x or np.array_equal(mesh.host_sum(x), x)
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert mesh.gather_objects(5) == [5]
    with use_mesh(mesh):
        assert current_mesh() is None          # one rank: no mesh
    for fp in (False, True):
        assert frame_axes(port_cfg(frame_parallel=fp)) == \
            jax_frame_axes(JConfig("volleyball").replace(frame_parallel=fp))


def test_shard_indices_match_din_tpu():
    from din_tpu.parallel.multihost import shard_indices_for_process as jax
    from din_tpu_torch.parallel.multihost import shard_indices_for_process

    for n, pc in ((23, 2), (16, 4), (7, 3)):
        for pi in range(pc):
            assert shard_indices_for_process(n, pi, pc) == jax(n, pi, pc)
    assert shard_indices_for_process(5) == list(range(5))   # no run joined


def test_multihost_init_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """No card: the default device (the card) raises; NCCL on the CPU
    raises; neither joins a run or falls back to gloo."""
    import torch.distributed as dist

    from din_tpu_torch.parallel.multihost import initialize_multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_multihost("tcp://127.0.0.1:1", 2, 0, timeout=1)
    with pytest.raises(ValueError, match="NCCL"):
        initialize_multihost("tcp://127.0.0.1:1", 2, 0, backend="nccl",
                             device="cpu", timeout=1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("pad", [False, True])
def test_even_batches_give_every_process_the_same_count(pad):
    """23 clips over 2 processes at batch 4: din_tpu's loader gives 3 and 2
    full batches; with ``even_batches`` both give 2 (training) or 3 (eval,
    the short process's last batch wholly masked), and the eval batches'
    real clips are every clip once."""
    from din_tpu_torch.data.loader import BatchLoader

    class Idx:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return {"i": np.array(i)}

    kw = dict(shuffle=False, num_workers=1, drop_last=not pad, pad_last=pad)
    loaders = [BatchLoader(Idx(), 4, process_index=p, process_count=2,
                           even_batches=True, **kw) for p in (0, 1)]
    plain = [BatchLoader(Idx(), 4, process_index=p, process_count=2, **kw)
             for p in (0, 1)]
    assert [len(x) for x in loaders] == ([3, 3] if pad else [2, 2])
    assert [len(x) for x in plain] == ([3, 3] if pad else [3, 2])
    real = []
    for x in loaders:
        batches = list(x)
        assert len(batches) == len(x)
        for b in batches:
            mask = b.get("sample_mask", np.ones(4))
            real += b["i"][mask > 0].tolist()
    assert sorted(real) == (list(range(23)) if pad else
                            sorted(list(range(0, 16, 2)) +
                                   list(range(1, 17, 2))))
