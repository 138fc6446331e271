"""The one traffic generator: closed-loop clients read from a mix's file.

A mix (`portbench/traffic/<name>.json`) gives:

  clients          closed-loop clients; each sends its next request as soon
                   as its previous frame is complete
  azimuth          "cycle": requests take, in the order they are sent, the
                   orbit azimuths 2 pi k / `poses` (k = 0 .. poses - 1), a
                   new permutation drawn from the seed for every round of
                   them, so every seed serves the same poses in another
                   order; "walk": client c starts at 2 pi c / clients (which
                   client starts where is drawn from the seed) and moves
                   `step_turns` of a full turn further every request
  poses            for "cycle"
  step_turns       for "walk"
  session          every client holds a sticky session id (the engine's
                   frame-coherent path)
  profile_frames   frames the traced run profiles, and then traces
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from portbench import inputs

BLOCK = 64                   # poses built per device copy


class _Bank:
    """Azimuths turned into cameras a block at a time (one device copy)."""

    def __init__(self, next_thetas: Callable[[int], np.ndarray],
                 config: dict, device, make_camera: Callable):
        self._next = next_thetas
        self._config, self._device = config, device
        self._make_camera = make_camera
        self._queue: list = []

    def pop(self):
        if not self._queue:
            thetas = self._next(BLOCK)
            poses = inputs.config_poses(self._config, thetas, self._device)
            self._queue = [(float(th), poses, i)
                           for i, th in enumerate(thetas)][::-1]
        theta, poses, i = self._queue.pop()
        return theta, (poses, i), self._make_camera(poses, i)


class Client:
    """One closed-loop client: where its poses come from, and its session."""

    def __init__(self, index: int, bank: _Bank, session: Optional[str]):
        self.index, self.session, self._bank = index, session, bank

    def next_pose(self):
        """(azimuth, (pose block, row), the port's camera)."""
        return self._bank.pop()


def _cycle(rng: np.random.Generator, n: int) -> Callable[[int], np.ndarray]:
    ring = 2 * math.pi * np.arange(n) / n
    queue: list = []

    def take(m: int) -> np.ndarray:
        while len(queue) < m:
            queue.extend(ring[rng.permutation(n)])
        out = np.array(queue[:m])
        del queue[:m]
        return out
    return take


def _walk(start: float, step: float) -> Callable[[int], np.ndarray]:
    state = [start]

    def take(m: int) -> np.ndarray:
        out = state[0] + step * np.arange(m)
        state[0] += step * m
        return out
    return take


def clients_for(mix: dict, config: dict, seed: int, device,
                make_camera: Callable) -> list[Client]:
    """The mix's clients for `seed`."""
    n = int(mix["clients"])
    rng = np.random.default_rng(seed & inputs.SEED_MASK)
    kind = mix["azimuth"]
    if kind == "cycle":
        shared = _Bank(_cycle(rng, int(mix["poses"])), config, device,
                       make_camera)
        banks = [shared] * n
    elif kind == "walk":
        step = 2 * math.pi * float(mix["step_turns"])
        banks = [_Bank(_walk(2 * math.pi * int(k) / n, step), config, device,
                       make_camera) for k in rng.permutation(n)]
    else:
        raise ValueError(f"unknown azimuth {kind!r}")
    return [Client(i, banks[i], f"client{i}" if mix.get("session") else None)
            for i in range(n)]


@dataclasses.dataclass
class Done:
    """One completed request (its frame is handed to `on_done` alone, so
    that a loop keeps no frame alive)."""
    client: int
    theta: float
    pose: tuple               # (pose block, row) as `Client.next_pose` gave
    latency_s: float
    t_done: float


@dataclasses.dataclass
class LoopStats:
    """What a loop did: every completed request, failures, dispatch walls,
    and how long each client took to send again after its frame."""
    done: list
    failed: int
    attempted: int
    window_s: float
    dispatch_s: list
    resend_s: list


def run_closed_loop(scheduler, scene: str, clients: list[Client], *,
                    seconds: Optional[float] = None,
                    frames: Optional[int] = None,
                    sync: Callable[[], None] = lambda: None,
                    on_done: Optional[Callable[[Done, object], None]] = None
                    ) -> LoopStats:
    """Drive `clients` against `scheduler` until `seconds` have passed (the
    dispatch that crosses the end completes inside the window) or `frames`
    requests have completed. A request's latency runs from just before its
    submit to the stamp after the dispatch that served it, taken after
    `sync()` (one device synchronise a dispatch). `on_done(done, result)`
    sees each completed request with the scheduler's `RequestResult`."""
    if (seconds is None) == (frames is None):
        raise ValueError("give seconds or frames")
    inflight = []
    idle = list(clients)
    done, failed, attempted, dispatch_s, resend_s = [], 0, 0, [], []
    last_done: dict = {}
    t0 = time.perf_counter()
    while True:
        for c in idle:
            theta, pose, camera = c.next_pose()
            t_submit = time.perf_counter()
            if c.index in last_done:
                resend_s.append(t_submit - last_done[c.index])
            fut = scheduler.submit(scene, camera, session=c.session)
            inflight.append((fut, c, theta, pose, t_submit))
            attempted += 1
        idle = []
        t_step = time.perf_counter()
        scheduler.step()
        sync()
        t_done = time.perf_counter()
        dispatch_s.append(t_done - t_step)
        still = []
        for fut, c, theta, pose, t_submit in inflight:
            if not fut.done():
                still.append((fut, c, theta, pose, t_submit))
                continue
            idle.append(c)
            last_done[c.index] = t_done
            if fut.exception() is not None:
                failed += 1
                continue
            d = Done(client=c.index, theta=theta, pose=pose,
                     latency_s=t_done - t_submit, t_done=t_done)
            done.append(d)
            if on_done is not None:
                on_done(d, fut.result())
        inflight = still
        if seconds is not None and t_done - t0 >= seconds:
            break
        if frames is not None and len(done) + failed >= frames:
            break
    # Requests left waiting at the close are served and not counted.
    scheduler.flush()
    sync()
    return LoopStats(done=done, failed=failed,
                     attempted=attempted - len(inflight),
                     window_s=t_done - t0, dispatch_s=dispatch_s,
                     resend_s=resend_s)


def to_device_sync(device) -> Callable[[], None]:
    """One synchronise of `device` (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
