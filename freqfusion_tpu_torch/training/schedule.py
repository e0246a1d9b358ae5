"""Learning-rate schedules and the multi-stage loss schedule. Twin of
``freqfusion_tpu/training/schedule.py``.

Each schedule is a plain function of the optimizer's update count that returns a float, the
same numbers as the JAX package's optax schedules (``optax.linear_schedule``,
``cosine_decay_schedule(alpha=...)`` and ``join_schedules``, boundaries included): linear
warmup for the first ``warmup_steps``, then cosine annealing with warm restarts (T0,
T_mult). ``torch.optim.lr_scheduler`` is not used: its step convention differs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over transition_steps, then end (init throughout
    where transition_steps <= 0, as optax)."""
    def lr(step: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return lr


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * (1 + cos(pi t / T)) / 2 + alpha)."""
    def lr(step: int) -> float:
        t = min(max(step, 0), decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)
    return lr


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i runs from boundary i - 1 on, counted from there."""
    def lr(step: int) -> float:
        start = 0
        for sched, boundary in zip(schedules, boundaries):
            if step < boundary:
                return sched(step - start)
            start = boundary
        return schedules[len(boundaries)](step - start)
    return lr


def cosine_warm_restarts(base_lr: float, t0_steps: int, t_mult: int = 2,
                         num_cycles: int = 6, eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingWarmRestarts (SGDR) over num_cycles periods of T0 * T_mult^i."""
    schedules, boundaries = [], []
    start, period = 0, t0_steps
    for _ in range(num_cycles):
        schedules.append(cosine_decay_schedule(base_lr, period,
                                               alpha=eta_min / max(base_lr, 1e-12)))
        start += period
        boundaries.append(start)
        period *= t_mult
    return join_schedules(schedules, boundaries[:-1])


def warmup_then_cosine_restarts(base_lr: float, warmup_steps: int, t0_steps: int,
                                t_mult: int = 2, num_cycles: int = 6) -> Schedule:
    """Linear warmup from base_lr / 100, then SGDR."""
    warmup = linear_schedule(base_lr * 1e-2, base_lr, warmup_steps)
    sgdr = cosine_warm_restarts(base_lr, t0_steps, t_mult, num_cycles)
    return join_schedules([warmup, sgdr], [warmup_steps])


class MultiStageLossScheduler:
    """Epoch -> loss-weight stage. `stages`: a list of {"epochs": [start, end),
    "stage_name": str, "weights": {...}}, contiguous from epoch 0."""

    def __init__(self, stages: Sequence[Dict]):
        if not stages:
            raise ValueError("at least one loss stage required")
        expected = 0
        for st in stages:
            lo, hi = st["epochs"]
            if lo != expected or hi <= lo:
                raise ValueError(f"stages must be contiguous from 0; got [{lo},{hi}) "
                                 f"expected start {expected}")
            expected = hi
        self.stages: List[Dict] = list(stages)
        self._last_idx = None

    def stage_index(self, epoch: int) -> int:
        for i, st in enumerate(self.stages):
            if st["epochs"][0] <= epoch < st["epochs"][1]:
                return i
        return len(self.stages) - 1   # clamp past the end

    def weights_for_epoch(self, epoch: int) -> Dict[str, float]:
        return dict(self.stages[self.stage_index(epoch)]["weights"])

    def is_transition(self, epoch: int) -> bool:
        idx = self.stage_index(epoch)
        changed = idx != self._last_idx
        self._last_idx = idx
        return changed

    def describe(self, epoch: int) -> str:
        st = self.stages[self.stage_index(epoch)]
        return (f"stage {self.stage_index(epoch)} ({st.get('stage_name', '?')}): "
                f"weights {st['weights']}")
