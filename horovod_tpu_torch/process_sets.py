"""Process sets: named subsets of ranks with their own collectives.

Port of ``horovod_tpu/process_sets.py`` (``ProcessSet`` :30,
``global_process_set`` :95, ``add_process_set`` :119,
``remove_process_set`` :140, ``get_process_set_ids`` :152). A set is a
``torch.distributed`` group over its ranks (``dist.new_group``); the global
set runs on the default group.

Registration is collective, unlike the reference's local table insert:
``dist.new_group`` must be called by every rank of the world, in the same
order, members or not. So every rank calls ``add_process_set`` and
``remove_process_set`` with the same sets in the same order, as the
reference's per-process host surfaces require (``process_world.py:106``).
Only members call a set's collectives; a non-member's call raises, as the
reference's native runtime refuses it.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch.distributed as dist

_lock = threading.Lock()


class ProcessSet:
    """A subset of ranks. ``process_set_id`` 0 is the global set."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks: list[int] = sorted(int(r) for r in ranks)
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        self.process_set_id: int = -1  # assigned on add
        # The set's torch.distributed group (None: the default group, or a
        # set that is not registered).
        self.group = None

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's rank within the set (-1 for non-members)."""
        from .basics import rank

        try:
            return self.ranks.index(rank())
        except ValueError:
            return -1

    def included(self) -> bool:
        return self.rank() >= 0

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


global_process_set = ProcessSet([])

_table: dict[int, ProcessSet] = {}
_next_id = 1


def _reset(world_size: int) -> None:
    """(Re)build the table at init(): register the global set as id 0 over
    the world."""
    global _next_id
    with _lock:
        _table.clear()
        _next_id = 1
        global_process_set.ranks = list(range(world_size))
        global_process_set.process_set_id = 0
        _table[0] = global_process_set


def _clear() -> None:
    with _lock:
        for ps in _table.values():
            ps.process_set_id = -1
            ps.group = None
        _table.clear()
        global_process_set.ranks = []


def add_process_set(process_set: ProcessSet | Sequence[int]) -> ProcessSet:
    """Register a new process set from a list of global ranks.

    Collective: every rank of the world calls it with the same ranks, in
    the same order as its other registrations (``dist.new_group``). Ranks
    out of the world's range, or the ranks of a set already registered
    (the global set included), raise ``ValueError`` on every rank.
    """
    from . import basics

    st = basics._state.require_init()
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    ranks = process_set.ranks
    if not ranks or ranks[0] < 0 or ranks[-1] >= st.size:
        raise ValueError(
            f"process set ranks {ranks} out of range for world size "
            f"{st.size}")
    global _next_id
    with _lock:
        for existing in _table.values():
            if existing.ranks == ranks:
                raise ValueError(
                    f"a process set with ranks {ranks} already exists: "
                    f"{existing}")
        group = dist.new_group(ranks)
        process_set.group = group if st.rank in ranks else None
        process_set.process_set_id = _next_id
        _table[_next_id] = process_set
        _next_id += 1
    return process_set


def remove_process_set(process_set: ProcessSet) -> bool:
    """Drop a registered subset; collective like :func:`add_process_set`.
    Returns False for the global set or a set that is not registered."""
    if process_set.process_set_id <= 0:
        return False
    with _lock:
        removed = _table.pop(process_set.process_set_id, None)
    if removed is None:
        return False
    if process_set.group is not None:
        dist.destroy_process_group(process_set.group)
    process_set.group = None
    process_set.process_set_id = -1
    return True


def get_process_set_ids() -> list[int]:
    """The ids of the registered sets, the global set's 0 first."""
    with _lock:
        return sorted(_table)
