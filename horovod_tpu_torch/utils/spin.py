"""A device spin that is timed, so that a spin that did not spin is seen.

A check that relies on the card being busy (a stall warning behind a spin,
timed calls queued behind one) launches ``torch.cuda._sleep``. If the spin
ended early, the check would time or wait for something else without
saying so. :class:`Spin` brackets the spin with CUDA events; once the
stream has passed them, :meth:`Spin.short` tells whether it ran for at
least half the time its cycles take at the card's highest clock.

The work queued behind a spin must use kernels the process has launched
before it. Under CUDA's lazy module loading (PyTorch's default) the first
launch of a kernel waits until the card is idle, so behind a spin the host
call that launches it returns only when the spin ends, and whatever the
host times or waits for after it finds the card done (``python3
chip_diag.py spins`` shows it: on an H100 80GB HBM3, a first ``x * 2``
behind a 2 s spin took 2.0003 s to launch and 0.0001 s to sync; loaded,
0.0001 s and 2.0000 s).
"""

from __future__ import annotations

#: The H100's highest SM clock: a spin of ``c`` cycles takes at least
#: ``c / MAX_SM_HZ`` seconds (longer at a lower clock).
MAX_SM_HZ = 1.98e9


class Spin:
    """``torch.cuda._sleep(cycles)`` on the current stream between two
    CUDA events. Read :meth:`ms` and :meth:`short` after the stream has
    passed the second event."""

    def __init__(self, cycles: int):
        import torch

        self.cycles = int(cycles)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        torch.cuda._sleep(self.cycles)
        self.end.record()

    def least_ms(self) -> float:
        """The spin's shortest possible time, at ``MAX_SM_HZ``."""
        return self.cycles / MAX_SM_HZ * 1e3

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)

    def short(self) -> bool:
        """The spin took less than half its shortest possible time."""
        return self.ms() < 0.5 * self.least_ms()
