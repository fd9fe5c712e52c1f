"""The plain reference against the program on tiny clips on the CPU (the
test imports both; the reference imports nothing of the program), and the
comparison's numbers."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from conftest import SEED

from perfbench.bench import correct, manifest, traffic as trafmod
from perfbench.reference.clip import clip_actions, pair_signal

CONFIGS = ("farneback-default", "dis-fast")


def clip(n=14, size=256, cut=True):
    tr = dict(manifest.cell("farneback-default.mixed").traffic, textures=2,
              scale_levels=64, size=[size, size])
    pool = trafmod.pool(tr, SEED, "cpu")
    spec = trafmod.ClipSpec(index=0, frames=n, texture=0, cut_texture=1,
                            cut_at=n // 2 if cut else n, period_s=0.5,
                            amplitude=0.08, phase=0.3)
    return trafmod.clip_frames(pool, spec, tr)


def params(config):
    return manifest.cell(f"{config}.mixed").config["params"]


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_matches_the_program(config):
    from funscript_flow_tpu_torch.models.pipeline import (FlowAnalyzer,
                                                          PipelineConfig)
    from funscript_flow_tpu_torch.runner import compute_actions
    from funscript_flow_tpu_torch.utils.params import Params

    p = params(config)
    frames = clip()
    ref_dots, ref_cuts = pair_signal(frames, p, "cpu", chunk=7)
    cfg = PipelineConfig(pair_batch=8, cut_threshold=p["cut_threshold"],
                         flow_algorithm="dis" if p["backend"] == "DIS"
                         else "farneback", dis_preset=p["dis_preset"])
    got = FlowAnalyzer(cfg, device="cpu").analyze_video_pairs(frames)
    assert ref_cuts.tolist() == got["cuts"].tolist()
    assert ref_cuts.any() and not ref_cuts.all()
    assert correct.dots_gap(got["dots"], ref_dots) <= 1e-6
    fps = 30.0
    actions, _ = compute_actions(got["dots"], got["cuts"],
                                 np.arange(len(ref_dots)), fps, fps,
                                 Params(**p))
    assert actions == clip_actions(ref_dots, ref_cuts, p, fps, 1)


@pytest.mark.parametrize("config", CONFIGS)
def test_bfloat16_reads_far_from_float32(config):
    """The control's precision moves the signal far past float32's."""
    p = params(config)
    frames = clip(cut=False)
    d32, c32 = pair_signal(frames, p, "cpu")
    d16, c16 = pair_signal(frames, p, "cpu", dtype=torch.bfloat16)
    assert correct.dots_gap(d16, d32) > 1e-3


def test_dots_gap():
    ref = np.array([0.0, 2.0, -4.0])
    assert correct.dots_gap(ref, ref) == 0.0
    assert correct.dots_gap(ref + [0, 0, 1], ref) == pytest.approx(0.25)
    assert correct.dots_gap(ref[:2], ref) == math.inf


def test_pos_gap_reads_the_curves():
    ref = [{"at": 0, "pos": 0}, {"at": 100, "pos": 100}]
    assert correct.pos_gap(ref, ref) == 0.0
    # one keyframe more, on the reference's line: no gap
    assert correct.pos_gap(ref[:1] + [{"at": 50, "pos": 50}] + ref[1:], ref) == 0.0
    assert correct.pos_gap([{"at": 0, "pos": 0}, {"at": 100, "pos": 90}],
                           ref) == pytest.approx(10.0)
    assert correct.pos_gap([], ref) == math.inf


def test_sample_takes_the_longest_and_one_from_the_seed():
    clips = [type("C", (), {"frames": n})() for n in (900, 4316, 1126, 2758)]
    picks = correct.sample(clips, SEED)
    assert picks[0] == 1 and len(picks) == 2 and picks[1] != 1
    assert picks == correct.sample(clips, SEED)
    assert correct.sample(clips[:1], SEED) == [0]
    assert correct.sample([], SEED) == []


def test_verdict():
    lim = {"dots_gap": 1e-4, "pos_gap": 3.0}
    assert correct.verdict({"dots_gap": 0.0, "pos_gap": 3.0}, lim, 0)
    assert not correct.verdict({"dots_gap": 0.0, "pos_gap": 0.0}, lim, 1)
    assert not correct.verdict({"dots_gap": math.inf, "pos_gap": 0.0}, lim, 0)
