"""Persistent multi-stream decode sessions (continuous batching) on one
device: counterpart of :mod:`music_tpu.generate.serving`.

A session holds a fixed capacity of streams that join and leave between
:meth:`step` calls.  Each call packs the active streams' tails into rows,
pads the rows to whole thread blocks with copies of the last stream, and
decodes every row ``steps_per_call`` samples in one kernel launch, re-primed
from each stream's tail: the last ``receptive_field + max(dilations)``
codes, a parallel conv forward that rebuilds the kernel's ring state.  The
kernel is the one :func:`~music_tpu_torch.generate.wavenet_generate.streams_weights`
routes the rows to (the resident or the weight-streaming decode); on the CPU
its plain version runs, as in the generate paths.

Not here: the data mesh and the multi-process row partitioning of the JAX
sessions (ROADMAP.md, A11).
"""

from __future__ import annotations

import numpy as np
import torch

from music_tpu_torch.generate import wavenet_ae_generate as aegen
from music_tpu_torch.generate import wavenet_generate as wngen
from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm
from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.conv import full_fp32
from music_tpu_torch.ops.mulaw import mu_law_decode

SEED_STRIDE = 7919  # the per-call seed advance, modulo 2**31


def _tiling(capacity: int | None, device: torch.device, resident, streaming, cfg,
            dtype: torch.dtype) -> tuple[int, int, int]:
    """``(capacity, n_streams, n_stream_groups)`` of a session: the
    admission bound (by default one block's tile of the kernel the rows
    are routed to), and the whole blocks its rows fill."""
    if capacity is not None and capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    kernel = (streaming if wngen.streams_weights(capacity or 1, device, resident, streaming,
                                                 cfg, dtype) else resident)
    tile = kernel.max_streams(cfg, dtype)
    capacity = capacity or tile
    S, G = wngen.stream_tiling(capacity, device, tile)
    return capacity, S, G


def _pad_rows(rows: list, total: int) -> list:
    """``rows`` filled up to ``total`` with copies of the last one."""
    return rows + [rows[-1]] * (total - len(rows))


class DecodeSession:
    """Serve WaveNet decode streams that join and leave over time.

    >>> sess = DecodeSession(cfg, params, capacity=32)
    >>> a = sess.add(); b = sess.add(prime_codes)
    >>> out = sess.step()          # {a: codes, b: codes}: one kernel launch
    >>> sess.finish(a)
    >>> c = sess.add()             # joins at the next step

    ``capacity``: the most concurrent streams, an admission bound that is
    never raised (default: one block's tile of the routed kernel,
    ``max_streams(cfg, dtype)``); the session launches whole blocks and
    decodes padding in the spare rows.  ``steps_per_call``: samples every
    stream advances per :meth:`step`.  ``backend``: ``"fused"`` (the decode
    kernel on a CUDA device, its plain version on the CPU) or ``"scan"``
    (the plain step loop, :func:`music_tpu_torch.models.wavenet.generate_tokens`).
    Each call advances the seed by 7919 (mod 2**31), so categorical streams
    draw new numbers every call.  ``device`` defaults to CUDA and raises
    without a card.
    """

    def __init__(
        self,
        cfg: wn.WaveNetConfig,
        params: dict,
        *,
        capacity: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        sample_mode: str = "categorical",
        temperature: float = 1.0,
        seed: int = 0,
        steps_per_call: int = 4096,
        backend: str = "fused",
        device: str | torch.device = "cuda",
    ):
        if backend not in wngen.BACKENDS:
            raise ValueError(f"backend must be one of {wngen.BACKENDS}, got {backend!r}")
        if backend == "fused":
            wavenet_decode._check_supported(cfg)  # use_bias, filter_width
        self.device = wngen.resolve_device(device)
        self.cfg, self.dtype, self.backend = cfg, dtype, backend
        self.params = wngen.load_params(cfg, params, None, self.device)
        self.sample_mode, self.temperature = sample_mode, temperature
        self.steps_per_call = int(steps_per_call)
        self._seed = int(seed) % 2**31
        self._prime_len = cfg.receptive_field + max(cfg.dilations)
        self.capacity, S, G = _tiling(capacity, self.device, wavenet_decode,
                                      wavenet_decode_hbm, cfg, dtype)
        self._rows = S * G
        self._streams: dict[int, np.ndarray] = {}
        self._next_sid = 0

    @property
    def active(self) -> list[int]:
        return list(self._streams)

    def add(self, prime: np.ndarray | None = None) -> int:
        """Admit a stream and return its id.  ``prime``: at least
        receptive_field + max dilation µ-law codes (default: silence, code
        Q // 2)."""
        if prime is None:
            prime = np.full((self._prime_len,), self.cfg.quantization_channels // 2, np.int32)
        prime = np.asarray(prime, np.int32)
        if prime.ndim != 1 or prime.shape[0] < self._prime_len:
            raise ValueError(f"prime must be [>= {self._prime_len}] codes, got {prime.shape}")
        if len(self._streams) >= self.capacity:
            raise RuntimeError(f"session full ({self.capacity} streams); finish() one first")
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = prime[-self._prime_len:]
        return sid

    def finish(self, sid: int) -> None:
        """Remove a stream; its row is free at the next :meth:`step`."""
        del self._streams[sid]

    def step(self) -> dict[int, np.ndarray]:
        """Advance every active stream ``steps_per_call`` samples in one
        decode call; returns ``{sid: [steps_per_call] int32 codes}``."""
        if not self._streams:
            return {}
        sids = list(self._streams)
        rows = np.stack(_pad_rows([self._streams[s] for s in sids], self._rows))
        prime = torch.from_numpy(rows).to(self.device)
        k = self.steps_per_call
        if self.backend == "fused":
            codes = wngen._fused_decode(self.params, prime, self.cfg, k, self.dtype,
                                        self.sample_mode, self.temperature, self._seed)
        else:
            codes = wngen._scan_decode(self.params, prime, self.cfg, k, self.sample_mode,
                                       self.temperature, self._seed)
        self._seed = (self._seed + SEED_STRIDE) % 2**31
        out = codes.cpu().numpy()
        result = {}
        for i, sid in enumerate(sids):
            result[sid] = out[i]
            self._streams[sid] = np.concatenate([self._streams[sid], out[i]])[-self._prime_len:]
        return result

    def audio(self, codes: np.ndarray) -> np.ndarray:
        """µ-law decode a stream's codes to float audio."""
        return mu_law_decode(torch.as_tensor(np.asarray(codes)),
                             self.cfg.quantization_channels).numpy()

    def state_dict(self) -> dict:
        """Per-stream tails and the counters: a session restored from it
        continues every stream exactly where this one left off (the tail
        is the whole decode state)."""
        return {
            "streams": {int(k): np.asarray(v) for k, v in self._streams.items()},
            "next_sid": self._next_sid,
            "seed": self._seed,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output (same config, enough capacity)."""
        streams = state["streams"]
        if len(streams) > self.capacity:
            raise ValueError(f"state has {len(streams)} streams, capacity {self.capacity}")
        for tail in streams.values():
            if np.asarray(tail).shape != (self._prime_len,):
                raise ValueError(
                    f"stream tail must be [{self._prime_len}], got {np.asarray(tail).shape}")
        self._streams = {int(k): np.asarray(v, np.int32) for k, v in streams.items()}
        self._next_sid = int(state["next_sid"])
        self._seed = int(state["seed"]) % 2**31


class AEDecodeSession:
    """Continuous batching of autoencoder reconstruction streams.

    >>> sess = AEDecodeSession(cfg, params)
    >>> a = sess.add(mu_law_codes_a)        # encodes once and admits
    >>> out = sess.step()                   # {a: codes}
    >>> b = sess.add(mu_law_codes_b)        # joins mid-flight
    >>> out = sess.step()                   # {a: ..., b: ...}

    Every stream keeps its bottleneck encoding (the true frames of its
    source), its tail and its clock, the absolute time of its tail's first
    code.  Each call hands the conditioned decode kernel (argmax) a
    fixed window of ``frame_window_width`` frames of each stream's
    encoding and the stream's clock on that window (``pos_offset``), so a
    call's conditioning tables stay the same size however long the clips
    are.  ``capacity``, ``steps_per_call`` and ``device`` as in
    :class:`DecodeSession`.
    """

    def __init__(
        self,
        cfg: ae.WaveNetAEConfig,
        params: dict,
        *,
        capacity: int | None = None,
        dtype: torch.dtype = torch.float32,
        steps_per_call: int = 4096,
        device: str | torch.device = "cuda",
    ):
        wavenet_ae_decode._check_supported(cfg)
        self.device = wngen.resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        self.params = aegen.load_params(cfg, params, None, self.device)
        self.steps_per_call = int(steps_per_call)
        self.capacity, S, G = _tiling(capacity, self.device, wavenet_ae_decode,
                                      wavenet_ae_decode_hbm, cfg, dtype)
        self._rows = S * G
        self._prime_len = cfg.receptive_field + max(cfg.dilations)
        self._pool = cfg.en_pool_kernel_size
        self._Fc = aegen.frame_window_width(self._prime_len, self.steps_per_call, self._pool)
        self._streams: dict[int, dict] = {}
        self._next_sid = 0

    @property
    def active(self) -> list[int]:
        return list(self._streams)

    def add(self, source_codes: np.ndarray) -> int:
        """Admit a reconstruction stream from its µ-law codes (at least
        receptive_field + max dilation of them); its first codes prime the
        decode.  The encoder runs once, here."""
        codes = np.asarray(source_codes, np.int32)
        if codes.ndim != 1 or codes.shape[0] < self._prime_len:
            raise ValueError(f"source must be [>= {self._prime_len}] codes, got {codes.shape}")
        if len(self._streams) >= self.capacity:
            raise RuntimeError(f"session full ({self.capacity} streams); finish() one first")
        # the encoder is causal: codes appended after the source (its last
        # one repeated, up to one whole frame) leave the frames the source
        # has unchanged, and a source shorter than a frame gets the one
        # frame the JAX session gives it
        one_frame = 1 + sum(self.cfg.dilations) + self._pool
        enc_codes = np.concatenate(
            [codes, np.full(max(0, one_frame - len(codes)), codes[-1], np.int32)])
        with torch.no_grad(), full_fp32():
            enc = ae.encode(self.params, torch.from_numpy(enc_codes)[None].to(self.device),
                            self.cfg)[0]
        true_frames = max(1, (len(codes) - 1 - sum(self.cfg.dilations)) // self._pool)
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = {"tail": codes[: self._prime_len], "clock": 0,
                              "enc": enc[:true_frames]}
        return sid

    def finish(self, sid: int) -> None:
        del self._streams[sid]

    def _window(self, enc: torch.Tensor, clock: int) -> tuple[torch.Tensor, int]:
        """The ``Fc``-frame window of ``enc`` for a call whose prime starts at
        ``clock``, and the prime's time on the window's clock; an encoding
        shorter than the window is padded with its last frame, which the
        kernel's clamp to the last frame reads as the source's own."""
        F, Fc = enc.shape[0], self._Fc
        if F >= Fc:
            f0, offset = aegen.frame_window(clock, F, Fc, self._pool)
            return enc[f0 : f0 + Fc], offset
        return torch.cat([enc, enc[-1:].expand(Fc - F, -1)]), clock

    def step(self) -> dict[int, np.ndarray]:
        """Advance every active stream ``steps_per_call`` samples in one
        decode call; returns ``{sid: [steps_per_call] int32 codes}``."""
        if not self._streams:
            return {}
        sids = list(self._streams)
        tails, wins, offs = [], [], []
        for sid in sids:
            st = self._streams[sid]
            win, offset = self._window(st["enc"], st["clock"])
            tails.append(st["tail"])
            wins.append(win)
            offs.append(offset)
        prime = torch.from_numpy(np.stack(_pad_rows(tails, self._rows))).to(self.device)
        encoding = torch.stack(_pad_rows(wins, self._rows))
        pos = torch.tensor(_pad_rows(offs, self._rows), dtype=torch.int64, device=self.device)
        k = self.steps_per_call
        codes = aegen._decode(self.params, encoding, prime, self.cfg, k, backend="fused",
                              sample_mode="argmax", seed=0, dtype=self.dtype, pos_offset=pos)
        out = codes.cpu().numpy()
        result = {}
        for i, sid in enumerate(sids):
            st = self._streams[sid]
            result[sid] = out[i]
            st["tail"] = np.concatenate([st["tail"], out[i]])[-self._prime_len:]
            st["clock"] += k
        return result

    def audio(self, codes: np.ndarray) -> np.ndarray:
        """µ-law decode a stream's codes to float audio."""
        return mu_law_decode(torch.as_tensor(np.asarray(codes)),
                             self.cfg.quantization_channel).numpy()

    def state_dict(self) -> dict:
        """Per-stream tails, clocks and encodings (no re-encode on restore)."""
        return {
            "streams": {
                int(k): {"tail": np.asarray(v["tail"]), "clock": int(v["clock"]),
                         "enc": v["enc"].cpu().numpy()}
                for k, v in self._streams.items()
            },
            "next_sid": self._next_sid,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output (same config, enough capacity)."""
        streams = state["streams"]
        if len(streams) > self.capacity:
            raise ValueError(f"state has {len(streams)} streams, capacity {self.capacity}")
        restored = {}
        for k, v in streams.items():
            tail = np.asarray(v["tail"], np.int32)
            if tail.shape != (self._prime_len,):
                raise ValueError(f"stream tail must be [{self._prime_len}], got {tail.shape}")
            restored[int(k)] = {"tail": tail, "clock": int(v["clock"]),
                                "enc": torch.as_tensor(np.asarray(v["enc"]), device=self.device)}
        self._streams = restored
        self._next_sid = int(state["next_sid"])
