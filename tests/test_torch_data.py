"""The port's Volleyball data path against din_tpu's, on the CPU.

Volleyball trees in the reference layout (``<sid>/annotations.txt``,
``<sid>/<src_fid>/<fid>.jpg``, ``tracks_normalized.pkl``), written here
with seeded noise frames, go through din_tpu's and the port's parsers,
datasets (every sampling policy, hflip, padding by repetition), loaders
(4 decode threads, two epochs, ``skip_batches``, ``pad_last``, process
shards), frame cache and packed store.  Everything is compared bit for
bit: both packages decode with the same ``din_loader.cc`` built here.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from din_tpu.config import Config as JaxConfig
from din_tpu.data import augment as jax_augment
from din_tpu.data import volleyball as jax_vb
from din_tpu.data.cache import FrameCache as JaxFrameCache
from din_tpu.data.loader import BatchLoader as JaxBatchLoader
from din_tpu.data.packed import PackedFrameStore as JaxPackedFrameStore
from din_tpu.data.packed import pack_frames as jax_pack_frames
from din_tpu_torch.config import Config
from din_tpu_torch.data import augment, volleyball
from din_tpu_torch.data.cache import FrameCache, make_cache
from din_tpu_torch.data.datasets import return_dataset
from din_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from din_tpu_torch.data.packed import (PackedFrameStore, make_frame_source,
                                       pack_frames)
from din_tpu_torch.experiments.presets import PRESETS
from test_torch_threads import one_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")

# video -> its clips' src_fid; clip (1, 20) has 3 actors, padded to 12
CLIPS = {0: (10, 20, 30), 1: (10, 20, 30), 2: (10, 20, 30)}
SHORT = (1, 20)
H, W = 24, 32
FEAT = (2, 3)


def write_tree(root, clips=CLIPS, size=(H, W), short=SHORT, seed=0):
    """A Volleyball tree: frames src-5 .. src+4 of every clip (noise JPEGs,
    quality 90), 12 normalized track boxes a frame (3 in ``short``), the
    activity and 12 actions of each clip.  Returns the tracks."""
    rng = np.random.RandomState(seed)
    h, w = size
    tracks = {}
    for sid, srcs in clips.items():
        lines = []
        for k, src in enumerate(srcs):
            n = 3 if (sid, src) == short else 12
            acts = rng.randint(0, 9, n)
            people = " ".join(
                "%d %d %d %d %s" % (rng.randint(w), rng.randint(h), 5, 8,
                                    jax_vb.ACTIONS[a]) for a in acts)
            lines.append("%d.jpg %s %s" % (
                src, jax_vb.ACTIVITIES[(3 * sid + k) % 8], people))
            os.makedirs(os.path.join(root, str(sid), str(src)))
            y1, x1 = rng.uniform(0, 0.8, (2, n))
            tracks[(sid, src)] = {}
            for fid in range(src - 5, src + 5):
                img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(
                    root, str(sid), str(src), f"{fid}.jpg"), quality=90)
                tracks[(sid, src)][fid] = np.stack(
                    [y1, x1, y1 + 0.15, x1 + 0.1], -1) + rng.uniform(
                        -0.01, 0.01, (n, 4))
        with open(os.path.join(root, str(sid), "annotations.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "tracks_normalized.pkl"), "wb") as f:
        pickle.dump(tracks, f)
    return tracks


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("videos"))
    return root, write_tree(root)


def _datasets(root, tracks, module="dynamic_volleyball", seqs=(0, 1),
              **kw):
    """(port, din_tpu) datasets of the same frames."""
    out = []
    for vb in (volleyball, jax_vb):
        anns = vb.volley_read_dataset(root, list(seqs))
        args = dict(anns=anns, tracks=tracks,
                    frames=vb.volley_all_frames(anns), images_path=root,
                    image_size=(H, W), feature_size=FEAT,
                    inference_module_name=module, num_boxes=12,
                    num_before=5, num_after=4, seed=3)
        args.update(kw)
        out.append(vb.VolleyballDataset(**args))
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_parser_equals_din_tpu(tree):
    root, _ = tree
    for sid in CLIPS:
        path = os.path.join(root, str(sid), "annotations.txt")
        got = volleyball.volley_read_annotations(path)
        want = jax_vb.volley_read_annotations(path)
        assert sorted(got) == sorted(want) == list(CLIPS[sid])
        for fid, a in want.items():
            for k in ("file_name", "group_activity", "actions"):
                assert got[fid][k] == a[k]
            assert got[fid]["bboxes"].dtype == np.float64
            np.testing.assert_array_equal(got[fid]["bboxes"], a["bboxes"])
    anns = volleyball.volley_read_dataset(root, [2, 0])
    assert volleyball.volley_all_frames(anns) == jax_vb.volley_all_frames(
        jax_vb.volley_read_dataset(root, [2, 0]))
    assert volleyball.volley_random_frames(
        anns, 5, np.random.RandomState(4)) == jax_vb.volley_random_frames(
        anns, 5, np.random.RandomState(4))
    assert volleyball.load_tracks(root).keys() == jax_vb.load_tracks(
        root).keys()


# every sampling policy of VolleyballDataset.sample_frames, hflip on
POLICIES = {
    "stage2": dict(),
    "stage1_finetune": dict(is_finetune=True),
    "arg_volleyball": dict(module="arg_volleyball", num_before=4,
                           num_after=4),
    "stage2_hflip": dict(hflip_prob=0.5),
}


@pytest.mark.parametrize("training", [True, False],
                         ids=["train", "eval"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_items_and_batches_equal_din_tpu_for_two_epochs(tree, policy,
                                                        training):
    """4 decode threads, two epochs: every batch of the port's loader
    equals din_tpu's bit for bit (clip frames, boxes padded by repetition,
    labels, flips), and the clip lengths are the policy's."""
    root, tracks = tree
    ours, theirs = _datasets(root, tracks, is_training=training,
                             **POLICIES[policy])
    T = {"stage2": 10, "stage2_hflip": 10,
         "stage1_finetune": 1 if training else 10,
         "arg_volleyball": 3 if training else 9}[policy]
    a = BatchLoader(ours, 2, shuffle=training, num_workers=4, seed=5,
                    drop_last=training, pad_last=not training)
    b = JaxBatchLoader(theirs, 2, shuffle=training, num_workers=4, seed=5,
                       drop_last=training, pad_last=not training)
    for epoch in (1, 2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        _assert_batches_equal(got, want)
        assert got[0]["images"].shape == (2, T, H, W, 3)
        assert got[0]["boxes"].shape == (2, T, 12, 4)


def test_hflip_flips_some_items_and_swaps_sides(tree):
    """With hflip_prob 0.5 some training items are mirrored: their frames
    are the unflipped item's mirrored, their activity the l/r swap."""
    root, tracks = tree
    plain, _ = _datasets(root, tracks, is_training=True)
    flip, _ = _datasets(root, tracks, is_training=True, hflip_prob=0.5)
    n = 0
    for i in range(len(plain)):
        p, f = plain[i], flip[i]
        if np.array_equal(p["images"], f["images"]):
            continue
        n += 1
        np.testing.assert_array_equal(f["images"], p["images"][:, :, ::-1])
        np.testing.assert_array_equal(
            f["activities"], augment.VOLLEY_ACTIVITY_HFLIP[p["activities"]])
    assert 0 < n < len(plain)


def test_hflip_clip_equals_din_tpu():
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 4, 6, 3) * 255).astype(np.uint8)
    boxes = rng.uniform(0, 3, (2, 3, 4)).astype(np.float32)
    mask = np.asarray([[True, False, True], [True, True, False]])
    acts = np.asarray([1, 6], np.int32)
    got = augment.hflip_clip(images, boxes, 3.0, acts,
                             augment.VOLLEY_ACTIVITY_HFLIP, mask)
    want = jax_augment.hflip_clip(images, boxes, 3.0, acts,
                                  jax_augment.VOLLEY_ACTIVITY_HFLIP, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_empty_roster_raises(tmp_path):
    root = str(tmp_path)
    tracks = write_tree(root, clips={0: (10,)}, short=None)
    tracks[(0, 10)] = {f: np.zeros((0, 4)) for f in tracks[(0, 10)]}
    ours, _ = _datasets(root, tracks, seqs=(0,))
    with pytest.raises(ValueError, match="no annotated boxes"):
        ours[0]


def test_draws_do_not_depend_on_thread_interleaving(tree):
    """Item content is a pure function of (seed, epoch, index): another
    access order, or 8 threads racing over the items with a short switch
    interval, gives the same items; another epoch draws other frames."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    root, tracks = tree
    ds, _ = _datasets(root, tracks, is_finetune=True, is_training=True,
                      hflip_prob=0.5)
    ds.set_epoch(3)
    fwd = [ds[i]["images"] for i in range(len(ds))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            racing = list(pool.map(lambda i: ds[i]["images"],
                                   reversed(range(len(ds)))))[::-1]
    finally:
        sys.setswitchinterval(old)
    for a, b in zip(fwd, racing):
        np.testing.assert_array_equal(a, b)
    draws = set()
    for epoch in range(12):
        ds.set_epoch(epoch)
        draws.add(ds[0]["images"].tobytes())
    assert len(draws) > 1


class _Idx:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.asarray([i], np.int64)}


@pytest.mark.parametrize("case", ["shuffle", "skip_batches", "pad_last",
                                  "two_processes"])
def test_batch_loader_equals_din_tpu(case):
    """Batch order and content of the port's BatchLoader against din_tpu's
    for a shuffled epoch, a resume that skips 3 batches, a padded remainder
    and each of two process shards; len() too."""
    kw = dict(shuffle=True, seed=7, num_workers=4)
    if case == "pad_last":
        kw.update(shuffle=False, drop_last=False, pad_last=True)
    runs = [dict(process_index=p, process_count=2) for p in (0, 1)] \
        if case == "two_processes" else [{}]
    for extra in runs:
        a = BatchLoader(_Idx(23), 4, **kw, **extra)
        b = JaxBatchLoader(_Idx(23), 4, **kw, **extra)
        skip = 3 if case == "skip_batches" else 0
        a.set_epoch(5, skip_batches=skip)
        b.set_epoch(5, skip_batches=skip)
        assert len(a) == len(b)
        got, want = list(a), list(b)
        _assert_batches_equal(got, want)
        if case == "skip_batches":
            a.set_epoch(5)
            assert [int(x) for g in list(a)[3:] for x in g["x"][:, 0]] == \
                [int(x) for g in got for x in g["x"][:, 0]]
        if case == "pad_last":
            assert got[-1]["sample_mask"].tolist() == [1, 1, 1, 0]
    if case == "two_processes":
        seen = [int(x) for extra in runs for g in BatchLoader(
            _Idx(23), 4, **kw, drop_last=False, **extra)
            for x in g["x"][:, 0]]
        assert sorted(seen) == list(range(23))


def test_loader_caps_workers_and_drops_queued_decodes_on_close():
    """num_workers is capped at the host's cores; a consumer that stops
    after one batch leaves no queued decode behind."""
    calls = []

    class Slow(_Idx):
        def __getitem__(self, i):
            calls.append(i)
            time.sleep(0.002)
            return super().__getitem__(i)

    loader = BatchLoader(_Idx(4), 2, num_workers=10 ** 6)
    assert loader.num_workers == os.cpu_count()
    loader = BatchLoader(Slow(400), 2, num_workers=1, shuffle=False,
                         decode_ahead=100)
    it = iter(loader)
    next(it)
    it.close()                  # 200 items were queued, 2 were needed
    n = len(calls)
    time.sleep(0.05)
    assert n < 50 and len(calls) == n


def test_frame_cache_budget_eviction_and_hits(tree):
    root, tracks = tree
    paths = [os.path.join(root, "0", "10", f"{f}.jpg") for f in range(5, 15)]
    cache = FrameCache(budget_mb=64)
    ref = JaxFrameCache(budget_mb=64)
    first = cache.load_frames(paths, H, W)
    np.testing.assert_array_equal(first, ref.load_frames(paths, H, W))
    assert (cache.misses, cache.hits) == (10, 0)
    np.testing.assert_array_equal(cache.load_frames(paths, H, W), first)
    assert (cache.misses, cache.hits) == (10, 10)
    assert len(cache) == 10 and cache.nbytes == 10 * H * W * 3
    small = FrameCache(budget_mb=6 * H * W * 3 / (1 << 20))
    small.load_frames(paths, H, W)
    assert len(small) == 6 and small.nbytes <= small.budget_bytes
    small.load_frames(paths[:4], H, W)            # evicted: misses again
    assert small.misses == 14 and small.hits == 0
    small.load_frames(paths[-2:], H, W)           # most recent: hits
    assert small.hits == 2
    assert make_cache(Config()) is None
    assert make_cache(Config(decode_cache_mb=32)).budget_bytes == 32 << 20


def test_packs_of_both_packages_are_byte_identical_and_cross_read(
        tree, tmp_path):
    root, _ = tree
    ours, theirs = str(tmp_path / "ours.pack"), str(tmp_path / "theirs.pack")
    n = pack_frames(root, ours, H, W, batch=7)
    assert n == jax_pack_frames(root, theirs, H, W, batch=7) == 90
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    paths = [os.path.join(root, "2", "30", f"{f}.jpg") for f in range(25, 35)]
    for store in (PackedFrameStore(theirs, root=root),
                  JaxPackedFrameStore(ours, root=root),
                  PackedFrameStore(ours)):              # relocatable suffix
        moved = paths if store.root else [
            p.replace(root, "/elsewhere/videos") for p in paths]
        np.testing.assert_array_equal(
            store.load_frames(moved, H, W),
            JaxFrameCache(64).load_frames(paths, H, W))
        assert (store.hits, store.misses) == (10, 0)


def test_pack_cli_writes_the_same_store(tree, tmp_path, capsys):
    """``python -m din_tpu_torch.data.packed`` writes what pack_frames
    writes and reports the frame count."""
    from din_tpu_torch.data import packed

    root, _ = tree
    out = str(tmp_path / "cli.pack")
    packed.main(["--root", root, "--out", out, "--height", str(H),
                 "--width", str(W), "--batch", "16"])
    assert f"{out}: 90 frames" in capsys.readouterr().out
    ref = str(tmp_path / "ref.pack")
    pack_frames(root, ref, H, W)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_packed_store_counts_misses_and_rejects_bad_files(tree, tmp_path):
    root, tracks = tree
    out = str(tmp_path / "part.pack")
    keys = [f"0/10/{f}.jpg" for f in range(5, 15)]
    assert pack_frames(root, out, H, W, keys=keys) == 10
    store = PackedFrameStore(out, root=root)
    clip = [os.path.join(root, "0", "20", f"{f}.jpg") for f in range(15, 25)]
    got = store.load_frames(clip + [os.path.join(root, k) for k in keys],
                            H, W)
    assert (store.hits, store.misses) == (10, 10)      # decoded live
    np.testing.assert_array_equal(got[:10],
                                  JaxFrameCache(64).load_frames(clip, H, W))
    with pytest.raises(ValueError, match="repack"):
        store.load_frames(clip, 2 * H, W)
    with open(out, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.pack")
    with open(cut, "wb") as f:
        f.write(data[:-100])
    with pytest.raises(ValueError, match="truncated"):
        PackedFrameStore(cut)
    with open(cut, "wb") as f:
        f.write(b"NOTAPACK" + data[8:])
    with pytest.raises(ValueError, match="not a DINPACK"):
        PackedFrameStore(cut)


def test_return_dataset_from_tree_and_pack(tree, tmp_path):
    """``return_dataset`` builds the Volleyball split from the tree, and
    from its pack (precedence pack > LRU > none) with equal items; the
    synthetic fixtures stay; a collective config finds no Collective
    Activity tree there (tests/test_torch_collective_data.py reads one)."""
    root, _ = tree
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        data_path=root, train_seqs=[0, 1], test_seqs=[2], image_size=(H, W),
        out_size=FEAT)
    assert make_frame_source(cfg) is None
    train, val = return_dataset(cfg)
    assert (len(train), len(val)) == (6, 3)
    assert train.is_training and not val.is_training and not train.is_finetune
    pack = str(tmp_path / "f.pack")
    pack_frames(root, pack, H, W)
    ptrain, pval = return_dataset(cfg.replace(packed_frames_path=pack,
                                              decode_cache_mb=8))
    assert isinstance(ptrain.cache, PackedFrameStore)
    assert ptrain.cache is pval.cache
    for a, b in ((train, ptrain), (val, pval)):
        for i in range(len(a)):
            _assert_batches_equal([a[i]], [b[i]])
    assert ptrain.cache.misses == 0
    assert isinstance(return_dataset(cfg.replace(decode_cache_mb=8))[0].cache,
                      FrameCache)
    s1, _ = return_dataset(PRESETS["volleyball_stage1"]().replace(
        data_path=root, train_seqs=[0], test_seqs=[2]))
    assert s1.is_finetune and (s1.num_before, s1.num_after) == (5, 4)
    syn_train, syn_val = return_dataset(cfg.replace(data_path="synthetic"))
    assert (len(syn_train), len(syn_val)) == (64, 16)
    with pytest.raises(FileNotFoundError, match="seq01"):
        return_dataset(Config("collective").replace(data_path=root))


def test_config_and_presets_match_din_tpu():
    """The new fields keep din_tpu's names and defaults, the splits and
    the presets' test_before_train too."""
    from din_tpu.experiments.presets import PRESETS as JAX_PRESETS

    names = ("train_seqs", "test_seqs", "data_path", "num_before",
             "num_after", "num_workers", "prefetch_depth", "decode_cache_mb",
             "packed_frames_path", "hflip_prob", "test_before_train",
             "eval_only")
    for ds in ("volleyball", "collective"):
        ours, theirs = Config(ds), JaxConfig(ds)
        assert [getattr(ours, n) for n in names] == \
            [getattr(theirs, n) for n in names]
    for p in ("volleyball_stage1", "volleyball_stage2_dynamic"):
        ours, theirs = PRESETS[p](), JAX_PRESETS[p]()
        assert [getattr(ours, n) for n in names] == \
            [getattr(theirs, n) for n in names]
    assert PRESETS["volleyball_stage1"]().test_before_train
    assert not PRESETS["volleyball_stage2_dynamic"]().test_before_train


def test_prefetch_on_the_cpu_passes_batches_and_producer_errors():
    """On the CPU the prefetch is a plain thread: it yields the batches as
    tensors, hands a producer's exception to the consumer, and a consumer
    that stops early closes the source."""
    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise RuntimeError("corrupt jpeg")
            yield {"x": np.full((2, 3), i, np.float32)}

    got = list(prefetch_to_device(source(5), "cpu", size=2))
    assert [int(b["x"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)

    it = prefetch_to_device(source(5, fail_at=2), "cpu", size=2)
    assert int(next(it)["x"][0, 0]) == 0
    assert int(next(it)["x"][0, 0]) == 1
    with pytest.raises(RuntimeError, match="corrupt jpeg"):
        next(it)

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield {"x": np.asarray([i])}
                i += 1
        finally:
            closed.set()

    it = prefetch_to_device(endless(), "cpu", size=2)
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert closed.wait(10)
