"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``) and makes its
stream of frames.

A mix lists frame shapes (W x H, LR pixels) and how they follow each other:

* ``"runs"``: the stream is cycles of one run of each shape, the three runs of a cycle of one
  length drawn from ``run_length`` (inclusive), their order shuffled and never starting with
  the shape that ended the cycle before, so every cycle holds the shapes in equal numbers, as
  a photo directory sorted by name does;
* ``"single"``: every frame has the first shape.

The order of shapes comes from the mix's own ``schedule_seed``, so that every ``--seed``
serves the same sizes in the same order and a window holds the same work; ``--seed`` draws
the pixels (uniform uint8 noise: every kernel does the same work whatever the pixels are)
and the sample of requests whose outputs are checked.
"""

from __future__ import annotations

import numpy as np


def schedule(mix: dict):
    """The stream's shapes, [(W, H)] of length ``mix["length"]``."""
    shapes = [tuple(s) for s in mix["shapes"]]
    n = mix["length"]
    if mix["order"] == "single":
        return [shapes[0]] * n
    if mix["order"] != "runs":
        raise ValueError(f"unknown order {mix['order']!r}")
    rng = np.random.default_rng(mix["schedule_seed"])
    lo, hi = mix["run_length"]
    out, last = [], None
    while len(out) < n:
        length = int(rng.integers(lo, hi + 1))
        order = [int(i) for i in rng.permutation(len(shapes))]
        if order[0] == last:
            order = order[1:] + order[:1]
        for i in order:
            out += [shapes[i]] * length
        last = order[-1]
    return out[:n]


def frame(seed: int, index: int, shape) -> np.ndarray:
    """Frame `index` of the stream for `seed`: HWC float32 in [0, 1], a uint8 payload."""
    w, h = shape
    rng = np.random.default_rng([int(seed), int(index)])
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8).astype(np.float32) / 255.0


def frames(mix: dict, seed: int):
    return [frame(seed, i, s) for i, s in enumerate(schedule(mix))]


def group_size(mix: dict) -> int:
    """Frames a whole-image dispatch groups, by ``infer.io.main``'s rule: one a replica on
    several cards (``n_devices``, the pipeline's ``u8_group_max``), else the mix's
    ``group_max`` (1 by default)."""
    n = mix.get("n_devices", 1)
    return n if n > 1 else mix.get("group_max", 1)


def groups(shapes, group_max: int, bucket_of):
    """Consecutive frames of one bucket grouped up to `group_max`, as the serving entry
    groups them: [[index, ...], ...]."""
    out, cur, cur_b = [], [], None
    for i, s in enumerate(shapes):
        b = bucket_of(s)
        if cur and (b != cur_b or len(cur) >= group_max):
            out.append(cur)
            cur = []
        cur.append(i)
        cur_b = b
    if cur:
        out.append(cur)
    return out


def sample(mix: dict, seed: int, shapes, group_max: int, bucket_of):
    """Indices of the requests whose outputs are checked, drawn from `seed` among the first
    ``mix["sample"]["first"]`` frames: max(shapes, group_max) of them, the k-th of shape k
    (the largest first) at position k of its group where such a frame is there, so that
    every shape, every replica's output and the gather between cards are checked."""
    rng = np.random.default_rng([int(seed), 7])
    first = min(mix["sample"]["first"], len(shapes))
    pos = {}
    for g in groups(shapes[:first], group_max, bucket_of):
        for p, i in enumerate(g):
            pos[i] = p
    kinds = sorted(set(shapes[:first]), key=lambda s: -s[0] * s[1])
    picked = []
    for k in range(max(len(kinds), group_max)):
        free = [i for i in range(first) if i not in picked]
        cands = ([i for i in free if shapes[i] == kinds[k % len(kinds)]
                  and pos[i] == k % group_max]
                 or [i for i in free if shapes[i] == kinds[k % len(kinds)]])
        if cands:
            picked.append(int(rng.choice(cands)))
    return sorted(picked)
