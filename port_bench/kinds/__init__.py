"""Generators of traffic, one module a kind; a mix file names its kind."""

import time


class Phases(dict):
    """Seconds of each named part of a set-up, in the order they ran."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self[name] = t - self._t
        self._t = t
