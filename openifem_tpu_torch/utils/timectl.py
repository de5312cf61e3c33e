"""Simulation time manager (reference: include/utilities.h:27-63,
source/utilities.cpp:6-36)."""

from __future__ import annotations


class Time:
    def __init__(self, time_end: float, delta_t: float,
                 output_interval: float, refinement_interval: float,
                 save_interval: float):
        self.timestep = 0
        self.time_current = 0.0
        self.delta_t = delta_t
        self.time_end = time_end
        self.output_interval = output_interval
        self.refinement_interval = refinement_interval
        self.save_interval = save_interval

    def current(self) -> float:
        return self.time_current

    def end(self) -> float:
        return self.time_end

    def get_delta_t(self) -> float:
        return self.delta_t

    def get_timestep(self) -> int:
        return self.timestep

    def _time_to(self, interval: float) -> bool:
        # integer-truncated interval division, as in the reference
        delta = int(interval / self.delta_t)
        if delta == 0:
            return False
        return self.timestep >= delta and self.timestep % delta == 0

    def time_to_output(self) -> bool:
        return self._time_to(self.output_interval)

    def time_to_refine(self) -> bool:
        return self._time_to(self.refinement_interval)

    def time_to_save(self) -> bool:
        return self._time_to(self.save_interval)

    def increment(self):
        self.time_current += self.delta_t
        self.timestep += 1

    def decrement(self):
        self.time_current -= self.delta_t
        self.timestep -= 1

    def set_delta_t(self, delta: float):
        self.delta_t = delta
