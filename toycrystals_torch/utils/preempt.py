"""Cooperative preemption for training loops (toycrystals_tpu/utils/preempt.py).

Spot and preemptible machines deliver SIGTERM with a short grace window.
`GracefulShutdown` latches SIGTERM and SIGINT into a flag instead of dying in
the middle of an epoch; the trainer polls `requested` at each epoch's end,
saves a checkpoint at once (whatever --ckpt-every says), skips the sample
grid, prints a hint to resume and exits 0. A second signal escalates to the
default handler.
"""

from __future__ import annotations

import os
import signal


class GracefulShutdown:
    """Context manager latching SIGTERM/SIGINT into a flag to poll.

    The first signal sets `requested` and records the signal's name; the
    second restores the default disposition and raises it again, so a stuck
    epoch can still be killed. Handlers are restored on exit; off the main
    thread (where signal.signal raises) the manager installs nothing.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self.requested = False
        self.signame: str | None = None

    def _handler(self, signum, frame):
        if self.requested:  # second signal: the default action
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signame = signal.Signals(signum).name
        # os.write, not print: the handler interrupts the main thread at any
        # bytecode, and re-entering a buffered writer that is mid-print
        # raises out of the training loop
        os.write(2, (f"\n{self.signame} received: finishing the current epoch, then "
                     "checkpointing and exiting (send again to kill now)\n").encode())

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
