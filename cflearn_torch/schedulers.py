"""Learning-rate schedulers (counterpart of `cflearn_tpu/schedulers.py`).

Every scheduler is a factory `f(lr, **config)` of a schedule: a function of
the optimizer's update count (0 at the first update) to the learning rate,
with the semantics of the optax schedules the JAX package builds on
(`linear_schedule`, `cosine_decay_schedule`, `warmup_cosine_decay_schedule`,
`join_schedules`, `constant_schedule`), computed in Python floats. `plateau`
is the one metric-driven scheduler: its schedule is constant, and its decay is
a `PlateauState` that the caller steps with the validation metric and
multiplies into the update (the optimizer's `lr_scale`).
"""

import math
from typing import Any, Callable, Dict, List, Optional

Schedule = Callable[[int], float]

scheduler_dict: Dict[str, Callable[..., Schedule]] = {}

# names whose updates are driven by the validation metric, not the step count
scheduler_requires_metric = {"plateau"}


def register_scheduler(name: str) -> Callable:
    def _core(fn: Callable[..., Schedule]) -> Callable:
        scheduler_dict[name] = fn
        return fn

    return _core


def build_scheduler(name: str, lr: float, **kwargs: Any) -> Schedule:
    if name not in scheduler_dict:
        raise ValueError(f"scheduler '{name}' is not registered (available: {sorted(scheduler_dict)})")
    return scheduler_dict[name](lr, **kwargs)


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0) -> Schedule:
    """optax's `linear_schedule`: init -> end over `transition_steps` updates
    from `transition_begin`, constant outside; constant init without steps."""
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(0, transition_begin)

    def schedule(count: int) -> float:
        count = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1.0 - count / transition_steps) + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax's `cosine_decay_schedule`: init * ((1 - alpha) * cos-decay + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + alpha)

    return schedule


def join_schedules(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """optax's `join_schedules`: past each boundary the next schedule, fed
    the count since that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


@register_scheduler("linear")
def _linear(lr: float, *, start_epoch: int = 0, end_epoch: int = 100, num_step_per_epoch: int = 1, **_: Any) -> Schedule:
    start = start_epoch * num_step_per_epoch
    end = max(start + 1, end_epoch * num_step_per_epoch)
    return linear_schedule(lr, 0.0, end - start, start)


@register_scheduler("linear_inverse")
def _linear_inverse(lr: float, *, decay: float = 0.001, floor_ratio: float = 0.01, **_: Any) -> Schedule:
    return lambda count: max(lr * floor_ratio, lr / (1.0 + decay * count))


@register_scheduler("step")
def _step(lr: float, *, step_size: int = 10, gamma: float = 0.1, floor_ratio: float = 0.0, **_: Any) -> Schedule:
    return lambda count: max(lr * floor_ratio, lr * gamma ** (count // step_size))


@register_scheduler("exponential")
def _exponential(lr: float, *, gamma: float = 0.99, floor_ratio: float = 0.0, **_: Any) -> Schedule:
    return lambda count: max(lr * floor_ratio, lr * gamma**count)


@register_scheduler("cosine")
def _cosine(lr: float, *, decay_steps: int = 10000, alpha: float = 0.0, **_: Any) -> Schedule:
    return cosine_decay_schedule(lr, decay_steps, alpha)


@register_scheduler("cosine_warmup")
def _cosine_warmup(
    lr: float,
    *,
    warmup_steps: int = 1000,
    decay_steps: int = 10000,
    init_ratio: float = 0.0,
    alpha: float = 0.0,
    **_: Any,
) -> Schedule:
    """optax's `warmup_cosine_decay_schedule(lr * init_ratio, lr,
    warmup_steps, warmup_steps + decay_steps, lr * alpha)`."""
    end_value = lr * alpha
    ratio = 0.0 if lr == 0.0 else end_value / lr
    return join_schedules(
        [linear_schedule(lr * init_ratio, lr, warmup_steps), cosine_decay_schedule(lr, decay_steps, ratio)],
        [warmup_steps],
    )


@register_scheduler("linear_warmup")
def _linear_warmup(lr: float, *, warmup_steps: int = 1000, init_ratio: float = 0.0, **_: Any) -> Schedule:
    return linear_schedule(lr * init_ratio, lr, warmup_steps)


@register_scheduler("warmup")
def _warmup(
    lr: float,
    *,
    multiplier: float = 1.0,
    warmup_step: int = 1000,
    afterwards: Optional[str] = None,
    afterwards_config: Optional[Dict[str, Any]] = None,
    **_: Any,
) -> Schedule:
    """Ramp from lr to lr * multiplier over `warmup_step` updates (starting
    at lr), then hand off to `afterwards` built at the peak."""
    peak = lr * multiplier
    if afterwards is None:
        after = constant_schedule(peak)
    else:
        after = build_scheduler(afterwards, peak, **(afterwards_config or {}))
    return join_schedules([linear_schedule(lr, peak, warmup_step), after], [warmup_step])


@register_scheduler("constant")
def _constant(lr: float, **_: Any) -> Schedule:
    return constant_schedule(lr)


@register_scheduler("plateau")
def _plateau(lr: float, **_: Any) -> Schedule:
    # the step -> lr part is constant; the metric-driven decay is a PlateauState's scale
    return constant_schedule(lr)


class PlateauState:
    """ReduceLROnPlateau on the host: `update(metric)` returns the scale of
    the learning rate, cut by `factor` after `patience` updates without an
    improvement beyond `threshold`, and never below `min_scale`."""

    def __init__(
        self,
        *,
        mode: str = "max",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_scale: float = 1e-8,
    ) -> None:
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.num_bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        better = (
            self.best is None
            or (self.mode == "max" and metric > self.best + self.threshold)
            or (self.mode == "min" and metric < self.best - self.threshold)
        )
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.min_scale, self.scale * self.factor)
                self.num_bad = 0
        return self.scale


# scheduler "ops": schedule factories under the reference's op names
scheduler_ops: Dict[str, Callable[..., Schedule]] = {}


def register_op(name: str) -> Callable:
    def _register(fn: Any) -> Any:
        scheduler_ops[name] = fn
        return fn

    return _register


# the reference's scheduler class names -> the factories that play their role
WarmupScheduler = _warmup
StepLRWithFloor = _step
ExponentialLRWithFloor = _exponential
LinearInverseScheduler = _linear_inverse
ReduceLROnPlateauWithGet = _plateau
LinearWarmupOp = register_op("linear")(_linear_warmup)
CosineWarmupOp = register_op("cosine")(_cosine_warmup)
