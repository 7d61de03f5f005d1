"""The two loops the cells run: a closed loop of clients on a serving
session, and the trainer's loop on its data path.

Serving.  Each client asks for a clip and, as soon as the call that
completes it returns, for the next, which joins the session at the next
call: a closed loop that keeps every row of the tile busy.  Set-up fills
the session with one clip a client whose remaining length is a dealt
length times a dealt fraction, so that the clients' phases are spread as
in a steady state, and then runs calls until every clip of that fill and
the first requests after it are done (the longest clip's calls and one
more); the first of those calls builds and loads the kernels.  The window
then opens on a call boundary and closes on the first call boundary at
least ``seconds`` later.

A rate is every sample that a real stream delivered in the window over the
window's wall time; a clip's latency runs from its request to the return
of the call that completes it, and every clip completed in the window
counts.

Training.  Set-up builds the trainer and its feed, the program's data
path (``AudioWindows`` batches through ``PrefetchBatches``), and runs the
checked steps through the same call and feed.  The window then runs steps
until ``seconds`` have passed, each ending with the loss read on the host
as the trainer's own loop reads it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench.trace import Spans, Window


@dataclasses.dataclass
class Clip:
    client: int
    length: int
    requested: float
    kept: bool
    delivered: int = 0
    sid: int = -1
    tokens: list = dataclasses.field(default_factory=list)
    draws: list = dataclasses.field(default_factory=list)


class ServeLoop:
    """The closed loop of ``server.clients`` clients on ``server``."""

    def __init__(self, server, t: dict, seed: int):
        self.server, self.t = server, t
        rng = np.random.default_rng(seed)
        self.lengths = gen.clip_lengths(t)
        self.deck = gen.Deck(self.lengths, rng)
        self.fill = gen.Deck(gen.quantiles(0.0, 1.0, t["deck"], "uniform"), rng)
        self.keep = np.random.default_rng(seed + 1)
        self.k = t["steps_per_call"]
        self.longest = int(self.lengths.max())
        self.spans = Spans()
        self.calls = 0
        self.pending: list[Clip] = []
        self.active: dict[int, Clip] = {}
        self.finished: list[Clip] = []

    def _request(self, client: int, at: float, fill: bool = False) -> None:
        length = int(self.deck.deal())
        if fill:
            length = max(1, int(np.ceil(length * (1.0 - self.fill.deal()))))
        # the check draws from the longest clips and a seeded share of the rest
        kept = length == self.longest or self.keep.random() < self.t["keep_share"]
        self.pending.append(Clip(client, length, at, kept))

    def warm_calls(self) -> int:
        return -(-self.longest // self.k) + 2

    def call(self, window: bool, stats: dict) -> None:
        """One call: the joins of the clips requested since the last, the
        session's step, the deliveries."""
        t0 = time.perf_counter()
        with self.spans("join"):
            for clip in self.pending:
                clip.sid = self.server.join(clip)
                self.active[clip.sid] = clip
        self.pending = []
        rows = self.server.rows() if any(c.kept for c in self.active.values()) else {}
        with self.spans("step"):
            out = self.server.step()
        t2 = time.perf_counter()
        for sid, codes in out.items():
            clip = self.active[sid]
            n = min(self.k, clip.length - clip.delivered)
            clip.delivered += n
            if clip.kept:
                clip.tokens.append(np.array(codes[:n]))
                clip.draws.append((self.calls, rows.get(sid, -1), n))
            if window:
                stats["samples"] += n
            if clip.delivered == clip.length:
                self.server.finish(sid)
                del self.active[sid]
                if window:
                    stats["latency"].append(t2 - clip.requested)
                    self.finished.append(clip)
                self._request(clip.client, t2)
        self.calls += 1
        if window:
            stats["calls"] += 1
            stats["call_s"].append(t2 - t0)

    def run(self, seconds: float, traced: bool, device) -> tuple[dict, Window]:
        """Set-up's fill and warm calls, then the window."""
        now = time.perf_counter()
        for client in range(self.server.clients):
            self._request(client, now, fill=True)
        stats = {"samples": 0, "latency": [], "calls": 0, "call_s": []}
        for _ in range(self.warm_calls()):
            self.call(False, stats)
        self.finished.clear()
        with Window(traced, device, self.spans) as w:
            t_open = stats["t_open"] = time.perf_counter()
            while True:
                self.call(True, stats)
                t_close = time.perf_counter()
                if t_close - t_open >= seconds:
                    break
        stats["window_s"] = t_close - t_open
        return stats, w

    def sample(self, seed: int) -> list[Clip]:
        """The clips the check compares: the longest finished and, drawn
        from the seed, others up to ``check_clips`` in all."""
        kept = [c for c in self.finished if c.kept]
        longest = [c for c in kept if c.length == self.longest][:1]
        rest = [c for c in kept if c not in longest]
        rng = np.random.default_rng(seed)
        n = min(len(rest), self.t["check_clips"] - len(longest))
        return longest + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]


def corpus(t: dict, seed: int, q: int, device) -> list[np.ndarray]:
    """The training corpus: ``corpus_clips`` sine mixtures of
    ``clip_seconds`` each, as µ-law codes."""
    n = int(round(t["clip_seconds"] * t["sample_rate"]))
    return gen.sine_codes(t, np.full(t["corpus_clips"], n), seed, q, device)


def window_starts(clips: list[np.ndarray], rf: int, wl: int) -> tuple[np.ndarray, np.ndarray]:
    """The concatenated codes and the start of every training window: one
    every ``wl`` codes of a clip, none crossing its end."""
    starts, offset = [], 0
    for clip in clips:
        for i in range(max((len(clip) - rf) // wl, 0)):
            if i * wl + rf + wl <= len(clip):
                starts.append(offset + i * wl)
        offset += len(clip)
    return np.concatenate(clips), np.asarray(starts, np.int64)


class TrainLoop:
    """The trainer fed by the program's data path."""

    def __init__(self, trainer, t: dict, clips: list[np.ndarray], rf: int, seed: int, device):
        from music_tpu_torch.data.audio import AudioWindows
        from music_tpu_torch.data.prefetch import PrefetchBatches
        from music_tpu_torch.train.wavenet_train import _staged

        self.trainer, self.t, self.device = trainer, t, device
        windows = AudioWindows(clips, receptive_field=rf, window_length=t["window_length"])
        batches = windows.batches(t["batch_size"], seed=seed, epochs=None)
        self.feed = PrefetchBatches(_staged(batches, torch.device(device)))
        self.spans = Spans()
        self.fed: list[torch.Tensor] = []
        self.losses: list[float] = []

    def _next(self) -> torch.Tensor:
        with self.spans("next_batch"):
            return next(self.feed)

    def checked_steps(self) -> dict:
        """The first steps, recorded for the check: the batches fed, each
        loss, the first gradient from the optimizer's state after step 1
        and the parameters after the last."""
        out = {}
        for i in range(self.t["checked_steps"]):
            tokens = self._next()
            self.fed.append(tokens.clone())
            with self.spans("train_step"):
                loss = self.trainer.step(tokens)
            self.losses.append(float(loss))
            if i == 0:
                out["grads"] = {k: v.clone() for k, v in self.trainer.first_grads().items()}
        out["params"] = {k: v.clone() for k, v in self.trainer.params().items()}
        return out

    def run(self, seconds: float, traced: bool) -> tuple[dict, Window]:
        stats = {"steps": 0, "wait_s": 0.0, "failed": 0}
        with Window(traced, torch.device(self.device), self.spans) as w:
            t_open = stats["t_open"] = time.perf_counter()
            while True:
                a = time.perf_counter()
                tokens = self._next()
                stats["wait_s"] += time.perf_counter() - a
                with self.spans("train_step"):
                    loss = self.trainer.step(tokens)
                stats["failed"] += not np.isfinite(float(loss))
                stats["steps"] += 1
                t_close = time.perf_counter()
                if t_close - t_open >= seconds:
                    break
        stats["window_s"] = t_close - t_open
        return stats, w

    def close(self) -> None:
        self.feed.close()
