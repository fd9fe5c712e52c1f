"""The traffic generator: clip plans and frames are functions of the seed,
and every seed runs the same clip lengths."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from conftest import SEED

from perfbench.bench import manifest, traffic as trafmod

MIXED = manifest.cell("farneback-default.mixed").traffic
TINY = dict(MIXED, textures=2, scale_levels=16, size=[32, 48])


def first(tr, seed, n):
    return list(itertools.islice(trafmod.plan(tr, seed), n))


def test_plan_is_a_function_of_the_seed():
    assert first(MIXED, SEED, 40) == first(MIXED, SEED, 40)
    assert first(MIXED, SEED, 40) != first(MIXED, SEED + 1, 40)


@pytest.mark.parametrize("seed", [0, 1, SEED, 2**40 + 3])
def test_every_block_holds_the_same_lengths(seed):
    lengths = trafmod.block_lengths(MIXED)
    assert lengths == [1126, 1762, 2758, 4316]
    assert all(900 <= n <= 5400 for n in lengths)
    specs = first(MIXED, seed, 4 * len(lengths))
    for b in range(4):
        block = specs[b * len(lengths):(b + 1) * len(lengths)]
        assert sorted(s.frames for s in block) == lengths
    for s in specs:
        assert 0.6 <= s.period_s <= 2.0 and 0.03 <= s.amplitude <= 0.08
        assert s.texture != s.cut_texture
        assert s.cut_at == s.frames or 0.2 * s.frames <= s.cut_at <= 0.8 * s.frames


def test_cut_share():
    specs = first(MIXED, SEED, 2000)
    share = np.mean([s.cut_at < s.frames for s in specs])
    assert 0.2 < share < 0.3


def test_frame_index_follows_the_zoom():
    spec = trafmod.ClipSpec(index=0, frames=120, texture=0, cut_texture=1,
                            cut_at=60, period_s=1.0, amplitude=0.08, phase=0.0)
    tex, lev = trafmod.frame_index(spec, MIXED)
    assert (tex[:60] == 0).all() and (tex[60:] == 1).all()
    assert lev.min() <= 2 and lev.max() >= MIXED["scale_levels"] - 3
    assert abs(lev[0] - (MIXED["scale_levels"] - 1) / 2) <= 1  # scale 1
    assert lev[7] > lev[0]  # the scale rises over the first quarter period
    assert (lev[:30] == lev[30:60]).all()  # period 1 s at 30 fps


def test_pool_and_source_are_functions_of_the_seed():
    a = trafmod.pool(TINY, SEED, "cpu")
    b = trafmod.pool(TINY, SEED, "cpu")
    c = trafmod.pool(TINY, SEED + 1, "cpu")
    assert a.shape == (2, 16, 32, 48) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert 100 < a.mean() < 156 and a.std() > 10
    spec = first(TINY, SEED, 1)[0]
    spec = trafmod.ClipSpec(**{**spec.__dict__, "frames": 50})
    frames = trafmod.clip_frames(a, spec, TINY)
    src = trafmod.PoolSource(a, spec, TINY)
    got = src.get_batch(20) + src.get_batch(100)
    assert len(got) == 50 and src.get_batch(5) == []
    assert np.array_equal(np.stack(got), frames)
    src.close()


def test_render_zooms_about_the_centre():
    tex = trafmod.textures(TINY, SEED, "cpu")
    one = trafmod.render(tex, [0], [1.0], 33, 33)
    big = trafmod.render(tex, [0], [1.05], 33, 33)
    assert one.dtype == torch.uint8 and one.shape == (1, 33, 33)
    assert one[0, 16, 16] == big[0, 16, 16]   # the centre stays
    assert not torch.equal(one, big)

