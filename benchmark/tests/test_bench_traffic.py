"""The traffic generator: inputs are a function of the seed, the easy/hard
split is exact, and every pair and clip frame is distinct."""

import numpy as np
import pytest
import torch

from benchmark.traffic.generate import draw_motions, load_mix, make_pool

BIG_SEED = 2 ** 31 + 12345


def small(name, **kw):
    mix = dict(load_mix(name), height=40, width=56, pool=2, render_chunk=4)
    mix.update(kw)
    if mix["kind"] == "clip":
        mix["margin_px"] = 160
    else:
        mix["margin_px"] = 20
    return mix


@pytest.mark.parametrize("name,batch", [("bulk_b1024_584x388", 12), ("clip_b64_1080p", 8)])
@pytest.mark.parametrize("transform", ["HOMOGRAPHY", "EUCLIDEAN"])
def test_same_seed_same_inputs(name, batch, transform):
    mix = small(name, batch=batch)
    a = make_pool(mix, transform, BIG_SEED, "cpu")
    b = make_pool(mix, transform, BIG_SEED, "cpu")
    c = make_pool(mix, transform, BIG_SEED + 1, "cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.i1, y.i1) and torch.equal(x.i2, y.i2)
        np.testing.assert_array_equal(x.motion, y.motion)
        assert not torch.equal(x.i1, z.i1)
        assert x.i1.dtype == torch.uint8 and x.i1.shape == (batch, 40, 56, 3)


def test_every_seed_gets_the_same_pairs_in_its_own_order():
    mix = small("bulk_b1024_584x388", batch=8)
    a = make_pool(mix, "HOMOGRAPHY", 1, "cpu")
    b = make_pool(mix, "HOMOGRAPHY", 2 ** 33 + 5, "cpu")

    def pairs(pool):
        return sorted(bytes(torch.cat([x.i1[j], x.i2[j]]).numpy()) for x in pool
                      for j in range(x.i1.shape[0]))

    assert pairs(a) == pairs(b)
    assert any(not torch.equal(x.i1, y.i1) for x, y in zip(a, b))
    assert sorted(int(x.hard.sum()) for x in a) == sorted(int(x.hard.sum()) for x in b)


@pytest.mark.parametrize("n", [4, 64, 1024])
def test_hard_share_is_exact(n):
    mix = load_mix("bulk_b1024_584x388")
    for seed in range(5):
        p, hard = draw_motions(np.random.default_rng(seed), n, "HOMOGRAPHY", 388, 584, mix)
        assert hard.sum() == round(0.25 * n)
        tr = np.abs(p[:, [2, 5]]).max(1)
        assert (tr[~hard] <= 3.0).all() and (np.abs(p[~hard][:, [0, 1, 3, 4]]) <= 2 / 584).all()
        assert (np.abs(p[hard][:, [0, 1, 3, 4]]) <= 35 / 584).all()


def test_pool_batches_keep_the_split_and_differ():
    mix = small("bulk_b1024_584x388", batch=16)
    pool = make_pool(mix, "HOMOGRAPHY", 3, "cpu")
    assert [int(b.hard.sum()) for b in pool] == [4, 4]
    assert not np.array_equal(pool[0].hard, pool[1].hard) or not np.allclose(
        pool[0].motion, pool[1].motion)


def _distinct(frames):
    flat = frames.reshape(frames.shape[0], -1)
    return len({bytes(f.numpy()) for f in flat}) == flat.shape[0]


def test_bulk_pairs_are_distinct():
    (b,) = make_pool(dict(small("bulk_b1024_584x388", batch=16), pool=1), "HOMOGRAPHY", 9, "cpu")
    assert _distinct(b.i1) and _distinct(b.i2)
    assert _distinct(torch.cat([b.i1, b.i2]))


def test_clip_frames_are_distinct_and_consecutive():
    """The pairs, in the seed's order, chain into one clip of B + 1 distinct
    frames: every I1 but the last frame's is another pair's I2."""
    (b,) = make_pool(dict(small("clip_b64_1080p", batch=10), pool=1), "EUCLIDEAN", 9, "cpu")
    assert _distinct(b.i1) and _distinct(b.i2)
    firsts = {bytes(f.numpy()) for f in b.i2}
    seconds = {bytes(f.numpy()) for f in b.i1}
    assert len(firsts & seconds) == 9 and len(firsts | seconds) == 11


def test_bulk_pair_follows_its_motion():
    """I1(x) = I2(x'(x; p)) up to the sensor noise, away from the border."""
    from benchmark.reference.align_ref import bicubic, grid

    mix = dict(small("bulk_b1024_584x388", batch=6, height=64, width=96, hard_share=0.0),
               pool=1, noise_sigma=0.0)
    (b,) = make_pool(mix, "HOMOGRAPHY", 4, "cpu")
    gx, gy = grid(torch.from_numpy(b.motion), "HOMOGRAPHY", 64, 96)
    iw = bicubic(b.i2.double(), gx, gy)
    err = (iw - b.i1.double())[:, 8:-8, 8:-8].abs()
    assert float(err.mean()) < 1.5
