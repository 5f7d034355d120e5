"""Typed event bus (port of `tpu_splat/utils/events.py`) — the observability spine
(reference: include/core/event_bus.hpp:33-200 and the ~50 event structs of
include/core/events.hpp).

Type-indexed pub/sub: subscribe by event class, emit instances. Thread-safe (the trainer
may run in a worker thread while a front-end listens, mirroring the reference's
trainer-thread / GUI split). The event set below covers the training-facing namespaces
(state::TrainingProgress events.hpp:82, cmd::StartTraining :41, state::CheckpointSaved
:122, state::EvaluationCompleted, MemoryUsage); viewer-only UI events are out of scope for
the headless build.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Type, TypeVar

E = TypeVar("E")


class Bus:
    """Type-indexed pub/sub singleton (event_bus.hpp:33)."""

    _instance: "Bus | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._handlers: dict[type, list[Callable[[Any], None]]] = defaultdict(list)

    @classmethod
    def instance(cls) -> "Bus":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def subscribe(self, event_type: Type[E], handler: Callable[[E], None]) -> Callable[[], None]:
        """Register a handler; returns an unsubscribe callable."""
        with self._lock:
            self._handlers[event_type].append(handler)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._handlers[event_type].remove(handler)
                except ValueError:
                    pass

        return unsubscribe

    def emit(self, event: Any) -> None:
        with self._lock:
            handlers = list(self._handlers.get(type(event), ()))
        for h in handlers:
            h(event)

    def clear(self) -> None:
        with self._lock:
            self._handlers.clear()


def emit(event: Any) -> None:
    """`.emit()` sugar (event_bus.hpp `Event` concept)."""
    Bus.instance().emit(event)


def when(event_type: Type[E], handler: Callable[[E], None]) -> Callable[[], None]:
    """`::when()` sugar."""
    return Bus.instance().subscribe(event_type, handler)


# --------------------------------------------------------------------- event vocabulary
# state::* (events.hpp:79-131)


@dataclass
class TrainingProgress:
    iteration: int
    total_iterations: int
    loss: float
    n_alive: int
    iters_per_s: float = 0.0


@dataclass
class TrainingStarted:
    total_iterations: int


@dataclass
class TrainingFinished:
    iteration: int


@dataclass
class CheckpointSaved:
    path: str
    iteration: int


@dataclass
class PlySaved:
    path: str
    iteration: int


@dataclass
class EvaluationCompleted:
    iteration: int
    psnr: float
    ssim: float
    lpips: float | None
    num_images: int


@dataclass
class RefinementCompleted:
    iteration: int
    info: dict = field(default_factory=dict)


# cmd::* (events.hpp:41-78) — honored by the trainer's control flags


@dataclass
class PauseTraining:
    pass


@dataclass
class ResumeTraining:
    pass


@dataclass
class StopTraining:
    pass


@dataclass
class SaveCheckpoint:
    pass


# state::* broadcasts (events.hpp:80-131) — the GL-GUI-only events (gizmos, split view,
# window focus) are deliberately out of scope with the replaced web viewer


@dataclass
class TrainingPaused:
    iteration: int


@dataclass
class TrainingResumed:
    iteration: int


@dataclass
class TrainingStopped:
    iteration: int


@dataclass
class TrainerReady:
    n_train_cameras: int
    n_val_cameras: int
    n_gaussians: int


@dataclass
class SceneLoaded:
    path: str
    n_cameras: int
    n_points: int


@dataclass
class ModelUpdated:
    iteration: int
    n_alive: int


@dataclass
class DatasetLoadStarted:
    path: str


@dataclass
class DatasetLoadCompleted:
    path: str
    n_cameras: int


@dataclass
class EvaluationStarted:
    iteration: int
    num_images: int


@dataclass
class MemoryUsage:
    bytes_in_use: int


@dataclass
class FrameRendered:
    """A live-viewer frame (viewer.py::TrainingViewerState.frame)."""

    width: int
    height: int
    render_ms: float
