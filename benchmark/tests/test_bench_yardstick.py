"""The yardstick's own arithmetic at toy sizes: the split generator, the
bytes of the roofline counts, the model FLOPs, the weights and tables."""

import numpy as np
import pytest
import torch

from harness import flops, roofline, weights
from harness.split import make_split, split_batches

SPLIT = dict(n_samples=50, n_clips=96, n_tracks=192, n_classes=7, n_rels=3,
             clips_per_movie=32, neighborhood=20)


def test_split_is_the_seeds():
    a = make_split(2 ** 31 + 11, **SPLIT)
    b = make_split(2 ** 31 + 11, **SPLIT)
    c = make_split(5, **SPLIT)
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert np.array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype
    assert not np.array_equal(a["feat_idx"], c["feat_idx"])


def test_split_shapes_and_locality():
    s = make_split(3, **SPLIT)
    fi, mask = s["feat_idx"], s["rels_mask"]
    assert fi.shape == (50, 20, 19, 3) and fi.dtype == np.int32
    assert mask.shape == (50, 20, 18)
    # every hypothesis shares the sample's ground-truth clip
    assert (fi[:, :, 0, 0] == fi[:, :1, 0, 0]).all()
    # a context pool of 4..18 distinct clips of the sample's movie, zeros
    # past it
    take = mask.sum(axis=2)
    assert take.min() >= 4 and take.max() <= 18
    assert (fi[:, :, 1:, :][mask == 0] == 0).all()
    movie = fi[:, 0, 0, 0] // 32
    ctx = fi[:, :, 1:, 0]
    assert ((ctx // 32 == movie[:, None, None]) | (mask == 0)).all()
    for n in range(5):
        for t in range(20):
            picks = ctx[n, t, :take[n, t]]
            assert len(set(picks.tolist())) == take[n, t]
    assert set(np.unique(s["mem_mask"].sum(axis=1))) <= set(range(3, 21))


def test_split_without_context():
    s = make_split(3, context=False, **SPLIT)
    assert s["feat_idx"].shape == (50, 20, 1, 3) and "rels_mask" not in s
    full = make_split(3, **SPLIT)
    assert np.array_equal(s["feat_idx"][:, :, 0], full["feat_idx"][:, :, 0])


def test_split_batches_keep_the_tail():
    parts = split_batches(make_split(3, **SPLIT), 16)
    assert [len(p["labels"]) for p in parts] == [16, 16, 16, 2]


def test_split_refuses_a_neighborhood_smaller_than_the_context():
    with pytest.raises(ValueError):
        make_split(3, **dict(SPLIT, neighborhood=10))


def test_pool_bytes_of_a_hand_worked_batch():
    # one sample, one hypothesis, R = 2: clip ids {1, 1}, tracks {2, 0} and
    # {3, 3}: 1 + 2 + 1 distinct rows
    fi = np.zeros((1, 1, 3, 3), np.int32)
    fi[0, 0, 1:] = [[1, 2, 3], [1, 0, 3]]
    moved, ops = roofline.pool_need(fi, (8, 4, 4), "bfloat16")
    rows = 1 * 8 * 2 + 2 * 4 * 2 + 1 * 4 * 2
    assert moved == rows + 2 * 3 * 4 + 2 * 4 + 16 * 4
    assert ops == 2 * 1 * 2 * 16


def test_scatter_bytes_of_a_hand_worked_step():
    moved, ops = roofline.scatter_need(10, (5, 6, 6), (4, 2, 2), "float32")
    want = (10 * 3 * 4 + 10 * 3 * 4 + (6 + 7 + 7) * 4
            + 10 * 8 * 4 + (5 * 4 + 6 * 2 + 6 * 2) * 4)
    assert moved == want and ops == 10 * 8


def test_bound_takes_the_larger_side():
    rates = {"hbm_bytes": 2.0, "f32_flops": 4.0}
    assert roofline.bound_s(10, 8, rates) == 5.0
    assert roofline.bound_s(2, 40, rates) == 10.0
    assert roofline.peak("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert roofline.peak("cpu") is None
    assert roofline.device_peak("cpu") is None


TINY = dict(text_dim=3, visual_dim=5, track_dim=5, joint_dim=4,
            mid_m_ints=6, n_classes=7, n_rels=2, n_hypotheses=2,
            n_clips=10, n_tracks=20, ctx=True, gates=True)


def test_flops_of_a_hand_worked_model():
    j = 4
    first = 2 * j * (10 * (3 + 5) + 20 * 2 * 5)
    second = 2 * 10 * 2 * j * j + 2 * 20 * 2 * j * (j // 2)
    assert flops.embed_flops(TINY) == 2 * (first + second)
    heads = 2 * 6 * (6 * j * 24 + 24 * 7 + 3 * j * 2)
    assert flops.head_flops(TINY, 6) == heads
    assert flops.eval_sweep_flops(TINY, 3) == 2 * (first + second) + heads
    step = (2 * 2 * 2 * j * (4 * 8 + 9 * 10)
            + 3 * (2 * flops.second_flops(TINY, 4) + flops.head_flops(
                TINY, 4)))
    assert flops.train_step_flops(TINY, 2, 4, 9) == step
    no_ctx = dict(TINY, ctx=False, gates=False)
    assert flops.head_flops(no_ctx, 1) == 2 * 3 * j * 7


def test_weights_and_tables_are_the_seeds():
    shapes = [("a.weight", (3, 4)), ("a.bias", (3,)), ("b.weight", (2, 9)),
              ("b.bias", (2,))]
    w = weights.make_weights(shapes, 2 ** 40 + 1, "cpu")
    again = weights.make_weights(shapes, 2 ** 40 + 1, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert w["a.weight"].abs().max() <= 0.5
    assert w["b.bias"].abs().max() <= 1 / 3
    assert not torch.equal(w["a.weight"], weights.make_weights(
        shapes, 3, "cpu")["a.weight"])
    t = weights.make_tables(TINY, 9, "cpu")
    assert t["text"].shape == (10, 3) and t["track"].shape == (20, 5)
    assert t["visual"].dtype == torch.float32
