"""Typed observability events.

The reference threads ``FnMut(Event)`` callbacks through every long-running
phase (``kmeans.rs:71-88`` ClusterEvent, ``db/build.rs:132-153`` BuildEvent,
``db/stored.rs:513-532`` and ``asyncdb/stored/query.rs:150-177`` QueryEvent).
We keep the same surface: every ``*_with_events`` API takes a callable that
receives one of the dataclasses below. Consumers typically timestamp them; for
on-device phases pair this with ``jax.profiler`` traces.

One deliberate divergence: PQ codebook training is *batched over divisions* on
the device (all D clusterings advance in lock-step in one program), so cluster
events during quantization carry a per-division gradient vector instead of
being emitted per division sequentially.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class Event:
    """Base class for all events."""


EventHandler = Callable[[Event], None]


def _noop(_: Event) -> None:
    pass


# --- clustering (kmeans.rs:71-88) -----------------------------------------

@dataclass
class StartingCentroidInitialization(Event):
    pass


@dataclass
class FinishedCentroidInitialization(Event):
    pass


@dataclass
class StartingCentroidUpdate(Event):
    round: int


@dataclass
class FinishedCentroidUpdate(Event):
    round: int
    gradient: Any  # scalar, or per-division vector in batched PQ training


@dataclass
class StartingCentroidReassignment(Event):
    round: int


@dataclass
class FinishedCentroidReassignment(Event):
    round: int


# --- build (db/build.rs:132-153) -------------------------------------------

@dataclass
class StartingIdAssignment(Event):
    pass


@dataclass
class FinishedIdAssignment(Event):
    pass


@dataclass
class StartingPartitioning(Event):
    pass


@dataclass
class FinishedPartitioning(Event):
    pass


@dataclass
class StartingSubvectorDivision(Event):
    pass


@dataclass
class FinishedSubvectorDivision(Event):
    pass


@dataclass
class StartingQuantization(Event):
    division: int


@dataclass
class FinishedQuantization(Event):
    division: int


@dataclass
class ClusterEvent(Event):
    """Wraps a clustering event raised during build (``build.rs:152``)."""
    event: Event


# --- query (db/stored.rs:513-532, asyncdb/stored/query.rs:150-177) ---------

@dataclass
class StartingQueryInitialization(Event):
    pass


@dataclass
class FinishedQueryInitialization(Event):
    pass


@dataclass
class StartingPartitionSelection(Event):
    pass


@dataclass
class FinishedPartitionSelection(Event):
    pass


@dataclass
class StartingPartitionQuery(Event):
    partition_index: int


@dataclass
class FinishedPartitionQuery(Event):
    partition_index: int


@dataclass
class StartingPartitionLoad(Event):
    """Async path: a partition file read began (``query.rs:162``)."""
    partition_index: int


@dataclass
class FinishedPartitionLoad(Event):
    partition_index: int


@dataclass
class StartingPartitionCentroidsLoad(Event):
    """Async path: partition-centroids file read began
    (``query.rs:153-155``)."""


@dataclass
class FinishedPartitionCentroidsLoad(Event):
    pass


@dataclass
class StartingCodebookLoad(Event):
    pass


@dataclass
class FinishedCodebookLoad(Event):
    pass


@dataclass
class StartingResultSelection(Event):
    pass


@dataclass
class FinishedResultSelection(Event):
    pass
