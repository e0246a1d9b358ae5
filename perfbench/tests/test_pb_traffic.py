"""The traffic generator: deterministic, the thirds, the run lengths, the tile plan."""

import collections

import numpy as np
import pytest

from perfbench.core import cell, traffic
from perfbench.reference import serving

SPEC = cell.Spec(cell.HERE.parent)


def runs_of(shapes):
    out = []
    for s in shapes:
        if out and out[-1][0] == s:
            out[-1][1] += 1
        else:
            out.append([s, 1])
    return out


def test_stream_runs_and_thirds():
    mix = SPEC.traffic("div2k-stream")
    shapes = traffic.schedule(mix)
    assert shapes == traffic.schedule(mix) and len(shapes) == mix["length"]
    runs = runs_of(shapes)
    assert all(1 <= n <= 12 for _, n in runs[:-1])
    assert len({n for _, n in runs}) > 6                  # lengths really vary
    # whole cycles hold each shape equally often
    counts, total, i = collections.Counter(), 0, 0
    while i + 3 <= len(runs) - 1:
        for s, n in runs[i:i + 3]:
            counts[tuple(s)] += n
        i += 3
    assert len(set(counts.values())) == 1 and set(counts) == {tuple(s) for s in mix["shapes"]}


def test_frames_depend_on_the_seed_only():
    a = traffic.frame(2147483911, 5, (510, 339))
    assert a.shape == (339, 510, 3) and a.dtype == np.float32
    assert np.array_equal(a, traffic.frame(2147483911, 5, (510, 339)))
    assert not np.array_equal(a, traffic.frame(2147483912, 5, (510, 339)))
    assert np.array_equal(np.round(a * 255), a * 255 // 1)   # a uint8 payload


def test_sample_covers_shapes_and_replica_positions():
    mix = {**SPEC.traffic("div2k-stream"), "n_devices": 4}
    assert traffic.group_size(mix) == 4 and traffic.group_size(SPEC.traffic("div2k-stream")) == 1
    shapes = traffic.schedule(mix)

    def bucket_of(s):
        return serving.bucket(s[1], s[0])

    picked = traffic.sample(mix, 99, shapes, 4, bucket_of)
    assert picked == traffic.sample(mix, 99, shapes, 4, bucket_of)
    assert {tuple(shapes[i]) for i in picked} == {tuple(s) for s in mix["shapes"]}
    pos = {i: p for g in traffic.groups(shapes, 4, bucket_of) for p, i in enumerate(g)}
    assert len({pos[i] for i in picked}) >= 3 and all(i < mix["sample"]["first"] for i in picked)


def test_tiled_plan_is_24_tiles_in_12_chunks():
    mix = SPEC.traffic("tiled-540p")
    w, h = mix["shapes"][0]
    hp, wp = serving.bucket(h, w)
    assert hp * wp > 280000                                  # past the whole-image budget
    ys, xs, ov_y, ov_x = serving.tile_plan(h, w, mix["tile"], mix["overlap"],
                                             mix["tile_batch"])
    assert (len(ys), len(xs)) == (4, 6)
    assert ys[0] == xs[0] == 0 and ys[-1] == h - 192 and xs[-1] == w - 192
    assert ov_y >= 32 and ov_x >= 32
    chunks, coords, _ = serving.tiles_of(np.zeros((h, w, 3), np.float32), 192, 32, 2)
    assert len(coords) == 24 and len(chunks) == 12 and chunks[0].shape == (2, 192, 192, 3)


def test_tile_plan_matches_the_program():
    from freqfusion_tpu_torch.infer.tiling import plan_grid
    for h, w in [(540, 960), (480, 640), (339, 510), (200, 900), (193, 193)]:
        for batch in (1, 2, 4):
            assert serving.tile_plan(h, w, 192, 32, batch) == plan_grid(h, w, 192, 32, batch)
