#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (music_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build all four CUDA kernels and the L2 read probe from
   ``music_tpu_torch/csrc/`` (one nvcc per source, started together), and
   meanwhile start ``torch.profiler`` (CUPTI) for phases 19-20;

WaveNet (kernel ``wavenet_decode``):

3. the kernel against its plain PyTorch version on the card at a tiny
   config: f32 argmax with 1 and 11 streams, bf16 with 16 streams,
   categorical (both sides draw the same Philox numbers); exact token
   matches, plus a tie-aware check against the plain model teacher-forced;
4. the main path at the shipped width (40 blocks, Cs=512, Q=256) through
   the CLI on a checkpoint of seeded random weights: one stream (argmax,
   f32) and 32 streams (categorical, bf16), 0.25 s each; launch counts,
   wav lengths and codes checked, and a tie-aware check of the first 512
   steps against the plain model on the card;
5. samples/s of the kernel (2048 steps) and of its plain version (64
   steps) at the main path's shapes, timed with CUDA events; the
   phase-timed build of the kernel (clock64 spans per phase, one f32
   stream); ``generate(backend="scan")`` on the card at the tiny config,
   tie-aware against the fused path's plain version and the f32 model;

WaveNet autoencoder (kernel ``wavenet_ae_decode``):

6. the kernel against its plain version at a tiny config with per-stream
   clocks (``pos_offset``) and frames that clamp at the last one: f32 with
   1 and 11 streams, bf16 with 16 streams; exact token matches, plus a
   tie-aware check against the plain f32 model teacher-forced;
7. the reconstruction path at the shipped width
   (``params/wavenet_autoencoder``: 40 blocks, Cs=512, W=512, pool=512,
   Q=256) through the CLI on a checkpoint of seeded random weights: one
   1.0 s source clip, then a directory of 32 clips, 0.25 s of output each,
   f32; launch counts, wav lengths and codes checked, and a tie-aware check
   of the first 512 steps against the plain f32 model;
8. samples/s of the kernel and its plain version for 1 and 32 streams;

Weight-streaming kernels (``wavenet_decode_hbm``, ``wavenet_ae_decode_hbm``)
at the 4.4x-scaled width (Cr = Cd = 64, Cs = 1024: 19.1 MB of f32 weights);
their working-dtype mode runs the resident body with per-layer skip, their
int8 modes the weight-streaming body:

9. the WaveNet kernel against its plain version at the tiny config in
   every mode (f32 argmax 1 and 11 streams, bf16 16 at the largest tile
   the working-dtype carve allows, categorical, int8 weights in f32 and
   bf16, int8 products with dynamic and static activation scales): exact
   token matches, a tie-aware check against the f32 model (on
   ``dequantized_params`` for int8 weights); then the tiny model trained
   on the card by the port's trainer step (Adam), where int8 products must
   agree with the f32 model on >= 99% of the tokens;
10. WaveNet at the scaled width, 0.25 s each: through the CLI with
    ``--params-dir`` one f32 stream, which the routing rule gives the
    weight-streaming kernel (the resident carve has no room for its helper
    warp in f32), and 32 bf16 categorical streams, which it gives the
    resident kernel; then through ``generate_batch`` 272 f32 categorical
    streams (on 132 SMs: past what the resident carve holds in one wave),
    4 a block on the weight-streaming kernel; one launch of the chosen
    kernel and none of the other, wavs, tie-aware checks of 512 steps (f32
    against the f32 model, the first 4 of the 272; bf16 against its plain
    version and against the f32 model);
11. the int8 modes at the scaled width (int8 weights with 1 f32 and 32
    bf16 streams, int8 products with 32 bf16 streams): 512 steps tie-aware
    against the plain version teacher-forced, and each mode's agreement
    with the f32 model printed;
12. the autoencoder kernel against its plain version at the tiny config
    with per-stream clocks and clamped frames (f32 1 and 11 streams, bf16
    16 at the largest working-dtype tile, int8 weights): exact token
    matches, tie-aware against the f32 model;
13. ``wavenet-ae generate`` at the scaled decoder width (0.25 s, f32) on
    one clip, on 32 and on 272 clips of 0.3 s (4 a block), all on the
    weight-streaming kernel: launches (none of the resident one), wavs,
    tie-aware 512 steps against the f32 model (the first 4 of the 272);
    int8 weights on the 32 clips against their plain version;
14. samples/s of both weight-streaming kernels (2048 steps) in each mode
    and at the tiles past the resident carve, their plain versions (64
    steps) at one stream a block, and the phase-timed build of the WaveNet
    kernel (one f32 stream, clock64 spans per phase); then both sides of
    the routing rule, kernels only: each resident kernel at the scaled
    width (WaveNet: 1 f32, 32 bf16, 272 f32 and 544 bf16 streams; AE: 1, 32
    and 272 clips) and each weight-streaming one at the shipped width
    (WaveNet: 1 f32 stream and 32 bf16 categorical; AE: 1 and 32 f32
    streams), each tiled by its own ``max_streams`` and timed against the
    other kernel on the same rows, with the rule's pick (every f32 case of
    up to 32 rows first checked tie-aware against the f32 model over 512
    steps);

15. one thread block's L2 read rate (``csrc/l2_probe.cu``) at the bytes a
    block of each timed case moves a step, and each case's one-SM floor;

Train, checkpoint and serve, at the shipped widths:

16. a dataset of seeded sine mixtures through ``dataset build-audio``;
    ``wavenet train`` for two epochs of the shipped dataset params (window
    40000, batch 4), resumed for a third; the trainer's step timed in f32
    and with ``compute_dtype`` bf16 (ms a step, pieces/s); ``wavenet-ae
    train`` for one epoch;
17. ``wavenet generate`` on the trained checkpoint (one f32 stream, B1),
    tie-aware against the plain model over 512 steps, and the share of
    steps whose top-2 logit margin exceeds 1e-3;
18. ``DecodeSession`` on the trained model: 32 bf16 categorical streams at
    4096 steps a call with streams joining and finishing (one launch a
    call; the last call split into prime and packs, kernel and the rest),
    and f32 argmax streams joining and leaving over three calls, tie-aware
    against the plain model as is an uninterrupted decode of each;
    ``AEDecodeSession`` on the trained autoencoder with the 32 clips of
    phase 7 (4 joining a call late), tie-aware on each stream's absolute
    clock, with the call's split and its conditioning-table build;

SeqGAN and LeakGAN at the shipped widths (no decode kernel on their paths;
float32 matmuls in full float32):

19. ``seqgan train`` (``params/seqgan``: V = 5000, E = H = 32, T = 20, batch
    64, rollout 16, D of 1720 filters) in a temporary working directory:
    the oracle corpus, MLE pretraining, D pretraining and the shipped 2
    adversarial rounds; both sample files checked and every loss and
    oracle NLL finite; the seconds of each MLE epoch, PG step (with its
    rollout) and D phase; ``rollout_rewards`` alone for 19,456 streams (ms,
    peak memory), a PG step's device busy share (``torch.profiler``) and
    peak memory, and the busy share of ten D steps; then at a tiny config
    a PG step on the card and on the CPU from the same weights and Gumbel
    noise (rewards within 1e-5, params and Adam state within 1e-5 of each
    leaf's scale);
20. ``leakgan train`` (``params/leak_gan``: V = 5258, G = 1720, goal 16,
    H = 32, T = 20, step 5, batch 64, rollout 4) on a 1,024-sequence corpus
    that the target-LSTM oracle writes from a seed, one epoch of each phase,
    then again resuming from its checkpoint; the seconds of the pre, D and
    adv phases; ``get_rewards`` alone for 1,024 streams, an adv step's busy
    share and peak memory, a pre step's busy share; then at the tiny
    config ``get_rewards``, one adv step and ``eval_nll`` on the card and
    the CPU from the same weights, noise and dropout masks (within 1e-5);
21. a JSON line describing each kernel (times in ms per decode step, with
    the least time the card could take for the same step, ``bound_ms``;
    launches counted over the main-path phases 4, 7, 10, 13, 17 and 18),
    then the device JSON as the last line.

It imports nothing of JAX.  Float32 matmuls in the plain versions run in
full float32 (TF32 off, see ``music_tpu_torch.ops.conv.full_fp32``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_F32 = 1e-4   # logits are O(0.1); kernel and plain differ in summation order only
# bf16 plain vs the f32 model: max logit error measured 4.5e-4 at the
# shipped width, 4.6e-4 at the scaled width and 3.5e-4 at the tiny config
# (H100); a token's deficit is at most twice the logit error, so 2e-3
# leaves a factor 2.2 over that bound
TOL_BF16 = 2e-3
# the same for the autoencoder at its tiny config: max logit error measured
# 1.49e-3 on the H100 and up to 1.85e-3 on the CPU
# (tests/test_torch_wavenet_ae_decode.py; the conditioning biases are bf16
# too), so twice 2e-3, times 2
TOL_AE_BF16 = 8e-3
TIMED_STEPS, PLAIN_STEPS = 2048, 64  # the plain versions are no yardstick of speed
TIMED_REPS = 2  # timed launches of TIMED_STEPS per kernel case, after a warm-up
PROBE_REPS = 10  # passes over the array in the timed launch of the L2 probe
PLAIN_STEPS_SCALED = 64  # the plain versions take 5-50 ms a step at the scaled width
TRAIN_STEPS = 5  # trainer steps timed at the shipped width, per dtype
SESSION_STEPS = 4096  # steps a session call, the sessions' default
KERNELS = ("wavenet_decode", "wavenet_ae_decode", "wavenet_decode_hbm", "wavenet_ae_decode_hbm")
PROBE = "l2_probe"  # csrc/l2_probe.cu: one block's L2 read rate, built with the kernels
# one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM bytes/s, and
# FLOP/s of the units the kernels' float32 FMAs run on, by weight dtype
# (bf16 operands could run on the tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


@dataclasses.dataclass
class TrainState:
    """Leaves keyed ``.params[...]``, as the trainer's checkpoints."""

    params: dict
    step: int


def card_identity() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def pcm_codes(wav_path: Path, q: int):
    """µ-law codes of a written wav: every 16-bit sample must be the PCM
    value of exactly one code."""
    import numpy as np
    import torch

    from music_tpu_torch.ops.mulaw import mu_law_decode

    with wave.open(str(wav_path), "rb") as f:
        if (f.getnchannels(), f.getsampwidth()) != (1, 2):
            fail(f"{wav_path} is not 16-bit mono PCM")
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2").astype(np.int64)
    table = mu_law_decode(torch.arange(q), q).numpy()
    table_pcm = (np.clip(table, -1, 1) * 32767.0).astype("<i2").astype(np.int64)
    if len(set(table_pcm.tolist())) != q:
        fail("µ-law levels collide in 16-bit PCM")
    codes = np.abs(pcm[:, None] - table_pcm[None, :]).argmin(axis=1)
    if not np.array_equal(table_pcm[codes], pcm):
        fail(f"{wav_path} holds samples that are no µ-law code")
    return codes


def step_macs(L, Cr, Cd, Cs, Q) -> int:
    """Multiply-adds of one decode step of one stream: per layer the
    filter/gate product [tap | x] @ [2Cr, 2Cd] and the dense product, then
    skip, post1 and post2."""
    return L * (2 * Cr * 2 * Cd + Cd * Cr) + L * Cd * Cs + Cs * Cs + Cs * Q


def bound(step_bytes: float, step_flops: float, dtype_name: str) -> tuple[float, str]:
    """The least time (ms) the card could take for one decode step, and
    which term bounds it."""
    t_bytes = step_bytes / PEAK_BYTES_S
    t_ops = step_flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def rate_line(rows: int, ker: float, plain: float | None, bnd: tuple) -> str:
    """One timed case: the kernel's and the plain version's ms a step as
    µs and samples/s, and the bound's share."""
    text = f"kernel {ker * 1e3:.1f} us/step = {rows / ker * 1e3:.0f} samples/s; "
    if plain is not None:
        text += f"plain {plain * 1e3:.1f} us/step = {rows / plain * 1e3:.0f} samples/s; "
    return text + (f"bound {bnd[0] * 1e3:.3f} us/step ({bnd[1]}, {100 * bnd[0] / ker:.3f}% of "
                   "the kernel's)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def model_packs(w: dict) -> dict:
    """The weight packs of a decode's inputs without the weight-streaming
    kernels' chain packs (``fg_t``, ``dense_t``: ``fg`` and ``dense``
    transposed and padded for the kernel to stage), so that every weight
    counts once."""
    return {k: v for k, v in w.items() if k not in ("fg_t", "dense_t")}


def block_step_bytes(w: dict, S: int, L: int, Cr: int, cond_elems: int = 0) -> int:
    """Bytes one thread block moves a decode step: every weight pack but the
    embeddings (of which it reads two rows), int8 scale rows included, read
    once; and per stream its L ring taps read and written and, for the
    autoencoder, its ``cond_elems`` conditioning values read."""
    weights = nbytes(*(v for k, v in model_packs(w).items() if k not in ("ecur", "eprev")))
    return weights + S * (2 * L * Cr + cond_elems) * w["ecur"].element_size()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def start_profiler() -> float:
    """Profile one tiny CUDA op (the first profile of a process starts
    CUPTI); its seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(4, device="cuda").sum()
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def timing_wrappers(dev, classes_methods: list[tuple[type, str]]):
    """Wrap each ``cls.method`` to record its seconds (device synchronised
    before and after) under ``"Cls.method"``, and the last instance under
    ``"Cls"``; returns ``(records, undo)``."""
    records: dict = {}
    originals = []
    for cls, name in classes_methods:
        orig = getattr(cls, name)
        originals.append((cls, name, orig))

        def wrapper(self, *args, _orig=orig, _key=f"{cls.__name__}.{name}", **kwargs):
            sync(dev)
            t0 = time.perf_counter()
            out = _orig(self, *args, **kwargs)
            sync(dev)
            records.setdefault(_key, []).append(time.perf_counter() - t0)
            records[type(self).__name__] = self
            return out

        setattr(cls, name, wrapper)

    def undo():
        for cls, name, orig in originals:
            setattr(cls, name, orig)

    return records, undo


def device_busy_share(dev, fn) -> tuple[float, float, float | None]:
    """``fn()``'s wall seconds (host clock, device synchronised), its device
    busy seconds (the CUDA activities ``torch.profiler`` records over a
    second call) and their ratio; ``None`` when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    wall = time.perf_counter() - t0
    if dev.type != "cuda":
        return wall, 0.0, None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-6
    return wall, busy, (busy / wall if busy > 0 else None)


def busy_line(wall: float, busy: float, share: float | None) -> str:
    return (f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms = "
            + (f"{100 * share:.1f}%" if share is not None
               else "not measured (the profiler saw no device time)") + " of it")


def tree_close(name: str, ours, theirs, rel: float) -> float:
    """Every leaf of ``ours`` within ``rel`` of the largest magnitude of the
    same leaf of ``theirs`` (the same key paths; integer leaves equal);
    returns the worst relative error."""
    import numpy as np
    import torch

    from music_tpu_torch.core.checkpoint import _flatten

    a, b = dict(_flatten(ours)), dict(_flatten(theirs))
    if list(a) != list(b):
        fail(f"{name}: key paths differ")
    worst = 0.0
    for path, want in b.items():
        got = a[path].detach().cpu().double() if isinstance(a[path], torch.Tensor) else a[path]
        want = want.detach().cpu().double() if isinstance(want, torch.Tensor) else want
        got, want = np.asarray(got), np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        worst = max(worst, err)
        if err > rel:
            fail(f"{name} {path}: card and CPU differ by {err:.3g} of the leaf's scale "
                 f"(tolerance {rel})")
    return worst


def gan_phases(card: str, dev, work_dir: Path, params_root: Path | None = None) -> dict:
    """Phases 19 (SeqGAN) and 20 (LeakGAN) at the widths of ``params_root``
    (default the shipped params), in ``work_dir``; returns the seconds each
    took.  They launch none of the decode kernels."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from music_tpu_torch import cli
    from music_tpu_torch.core import checkpoint
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.models import leakgan as lg
    from music_tpu_torch.models import seqgan as sg
    from music_tpu_torch.ops.sampling import gumbel_noise
    from music_tpu_torch.train import leakgan_train, seqgan_train

    params_root = params_root or ROOT / "music_tpu_torch" / "params"

    if torch.backends.cuda.matmul.allow_tf32:
        fail("[19] TF32 matmuls are on: the GAN phases hold float32 parity")
    seconds = {}
    floats = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf")

    def run_cli(argv: list[str]) -> str:
        """The CLI in ``work_dir``, its output echoed with its wall and returned."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main([*argv, "--device", dev.type])
        sync(dev)
        print("".join(f"    {line}\n" for line in buf.getvalue().splitlines())
              + f"    ({' '.join(argv[:2])}: {time.perf_counter() - t0:.1f} s)", flush=True)
        return buf.getvalue()

    def finite_numbers(label: str, out: str) -> list[float]:
        nums = [float(x) for x in floats.findall(out.split(":", 1)[-1])]
        if not nums or not np.all(np.isfinite(nums)):
            fail(f"{label}: a loss is not finite: {out.strip()}")
        return nums

    def reset_peak() -> None:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def peak() -> str:
        n = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        return f"{n / 2**20:.0f} MiB" if n else "not measured"

    cwd = os.getcwd()
    os.chdir(work_dir)
    try:
        # -- 19. SeqGAN at the shipped width
        t_phase = time.perf_counter()
        p = load_params_dir(params_root / "seqgan")["params"]
        records, undo = timing_wrappers(dev, [
            (seqgan_train.SeqGanTrainer, "pretrain_generator"),
            (seqgan_train.SeqGanTrainer, "pg_step"),
            (seqgan_train.SeqGanTrainer, "train_discriminator")])
        try:
            out = run_cli(["seqgan", "train", "--params-dir", str(params_root / "seqgan")])
        finally:
            undo()
        for line in out.splitlines():
            finite_numbers(f"[19] seqgan train, {line.split(':')[0]}", line)
        positive = seqgan_train.read_samples(work_dir / "data" / "seqgan" / "positive.txt")
        generated = seqgan_train.read_samples(work_dir / "data" / "seqgan" / "generated.txt")
        for name, rows in (("positive", positive), ("generated", generated)):
            if rows.shape != (p["generated_num"], p["seq_len"]) or rows.min() < 0 or (
                    rows.max() >= p["vocab_size"]):
                fail(f"[19] {name}.txt holds {rows.shape} ids in [{rows.min()}, {rows.max()}]")
        tr = records["SeqGanTrainer"]
        cfg = tr.cfg
        n_streams = cfg.rollout_num * (cfg.g.seq_len - 1) * cfg.batch_size
        print(f"[19] seqgan train, shipped width (V={cfg.g.vocab_size}, E=H={cfg.g.hidden_dim}, "
              f"T={cfg.g.seq_len}, batch {cfg.batch_size}, rollout {cfg.rollout_num}, D "
              f"{cfg.d.feature_dim} filters): both sample files of {len(positive)} sequences; "
              f"MLE epoch {records['SeqGanTrainer.pretrain_generator'][0]:.3f} s "
              f"({len(positive) // cfg.batch_size} steps, first call), PG steps with their "
              "rollouts " + ", ".join(f"{s:.3f}" for s in records["SeqGanTrainer.pg_step"])
              + " s, D phases (pretrain 1 x 1 epoch, then 5 x 3 epochs a round) "
              + ", ".join(f"{s:.3f}" for s in records["SeqGanTrainer.train_discriminator"])
              + f" s  [{card}]", flush=True)

        print(f"    (phase 19 at {time.perf_counter() - t_phase:.1f} s)", flush=True)
        # the rollout alone, 19,456 streams (host clock, device synchronised)
        gen = torch.Generator(device=dev).manual_seed(19)
        samples = sg.generate(tr.g_params, cfg.g, cfg.batch_size, generator=gen)
        roll = lambda: sg.rollout_rewards(tr.g_params, tr.d_params, samples, g_cfg=cfg.g,
                                          d_cfg=cfg.d, rollout_num=cfg.rollout_num,
                                          generator=gen)
        roll()
        sync(dev)
        reset_peak()
        t0 = time.perf_counter()
        for _ in range(3):
            rewards = roll()
        sync(dev)
        roll_ms = (time.perf_counter() - t0) / 3 * 1e3
        if rewards.shape != (cfg.batch_size, cfg.g.seq_len) or not torch.isfinite(rewards).all():
            fail(f"[19] rollout rewards {tuple(rewards.shape)}, finite "
                 f"{bool(torch.isfinite(rewards).all())}")
        roll_peak = peak()
        reset_peak()
        wall, busy, share = device_busy_share(dev, lambda: tr.pg_step(generator=gen))
        pg_peak = peak()
        print(f"[19] rollout_rewards, {n_streams} streams: {roll_ms:.1f} ms (mean of 3, "
              f"peak memory {roll_peak}); a PG step {busy_line(wall, busy, share)}, peak "
              f"memory {pg_peak}  [{card}]", flush=True)
        # ten D steps on one batch, half positives and half negatives
        half = cfg.batch_size // 2
        d_toks = torch.cat([torch.from_numpy(positive[:half]).long().to(dev),
                            sg.generate(tr.g_params, cfg.g, half, generator=gen)])
        d_labels = torch.cat([torch.ones(half), torch.zeros(half)]).long().to(dev)
        wall, busy, share = device_busy_share(dev, lambda: [
            tr.d_step(d_toks, d_labels, dropout_generator=gen) for _ in range(10)])
        print(f"[19] ten D steps of {len(d_toks)}: {busy_line(wall, busy, share)}  [{card}]",
              flush=True)

        print(f"    (phase 19 at {time.perf_counter() - t_phase:.1f} s)", flush=True)
        # card against CPU at a tiny config: the same weights and noise
        tiny = seqgan_train.SeqGanConfig(
            g=sg.GeneratorConfig(vocab_size=50, emb_dim=8, hidden_dim=8, seq_len=10),
            d=sg.DiscriminatorConfig(vocab_size=50, emb_dim=8, filter_sizes=(1, 2, 3),
                                     num_filters=(8, 8, 8), seq_len=10),
            batch_size=4, rollout_num=3)
        pair = [seqgan_train.SeqGanTrainer(tiny, seed=19, device=d) for d in ("cpu", dev)]
        noise_gen = torch.Generator().manual_seed(190)
        sample_noise = gumbel_noise(noise_gen, (10, 4, 50))
        rollout_noise = gumbel_noise(noise_gen, (9, 3 * 9 * 4, 50))
        outs = [t.pg_step(sample_noise=sample_noise, rollout_noise=rollout_noise)
                for t in pair]
        err_r = float((outs[0][1] - outs[1][1].cpu()).abs().max())
        if err_r > 1e-5:
            fail(f"[19] rollout rewards on the card and the CPU differ by {err_r:.3g}")
        err_p = tree_close("[19] pg_step params", pair[1].g_params, pair[0].g_params, 1e-5)
        err_o = tree_close("[19] pg_step Adam state", pair[1].g_opt, pair[0].g_opt, 1e-5)
        print(f"[19] tiny config, card vs CPU on the same weights and noise: rollout rewards "
              f"within {err_r:.2g}, pg_step params within {err_p:.2g} and Adam state within "
              f"{err_o:.2g} of their scale (tolerance 1e-5)", flush=True)
        seconds["19"] = time.perf_counter() - t_phase

        # -- 20. LeakGAN at the shipped width on an oracle corpus of 1,024
        t_phase = time.perf_counter()
        lp = load_params_dir(params_root / "leak_gan")
        lcfg = lg.LeakGanConfig.from_json(lp["leak_gan_params"])
        ltp = lp["train_params"]
        oracle = leakgan_train.LeakGanTrainer(
            leakgan_train.LeakGanTrainConfig(cfg=lcfg, batch_size=ltp["batch_size"]),
            seed=20, device=dev)
        corpus = oracle.oracle_samples(1024)
        np.save(work_dir / "corpus.npy", corpus)
        del oracle
        print(f"    (phase 20 at {time.perf_counter() - t_phase:.1f} s: the oracle corpus)",
              flush=True)
        records, undo = timing_wrappers(dev, [
            (leakgan_train.LeakGanTrainer, "pretrain_generator"),
            (leakgan_train.LeakGanTrainer, "pretrain_discriminator"),
            (leakgan_train.LeakGanTrainer, "adv_step")])
        argv = ["leakgan", "train", "--params-dir", str(params_root / "leak_gan"), "--corpus",
                str(work_dir / "corpus.npy"), "--checkpoint", str(work_dir / "leakgan_ckpt")]
        try:
            first = run_cli(argv)
            second = run_cli(argv)
        finally:
            undo()
        for out in (first, second):
            for line in out.splitlines():
                if line.startswith(("pretrain", "epoch")):
                    finite_numbers(f"[20] leakgan train, {line.split(':')[0]}", line)
        if "resumed from step 0" not in first or "resumed from step 1" not in second:
            fail("[20] the second leakgan train did not resume from the first's checkpoint")
        if checkpoint.latest_step(work_dir / "leakgan_ckpt") != 1:
            fail("[20] no checkpoint at step 1")
        ltr = records["LeakGanTrainer"]
        tc = ltr.tc
        rows = lambda key: ", ".join(f"{s:.3f}" for s in records[key])
        print(f"[20] leakgan train twice (resumed), shipped width (V={tc.cfg.vocab_size}, "
              f"G={tc.cfg.goal_out_size}, goal {tc.cfg.goal_size}, H={tc.cfg.worker_hidden}, "
              f"T={tc.cfg.seq_len}, step {tc.cfg.step_size}, batch {tc.batch_size}, rollout "
              f"{tc.rollout_num}) on {len(corpus)} oracle sequences: pre epochs "
              f"{rows('LeakGanTrainer.pretrain_generator')} s, D epochs (negatives "
              f"included) {rows('LeakGanTrainer.pretrain_discriminator')} s, adv steps "
              f"{rows('LeakGanTrainer.adv_step')} s  [{card}]", flush=True)

        print(f"    (phase 20 at {time.perf_counter() - t_phase:.1f} s)", flush=True)
        # get_rewards alone, 1,024 streams
        lgen = torch.Generator(device=dev).manual_seed(20)
        cfg_l = tc.cfg
        x = lg.gen_samples(ltr.g_params, ltr.d_params, tc.batch_size, cfg=cfg_l, generator=lgen)
        rew = lambda: lg.get_rewards(ltr.g_params, ltr.d_params, x, cfg=cfg_l,
                                     rollout_num=tc.rollout_num, generator=lgen)
        rew()
        sync(dev)
        reset_peak()
        t0 = time.perf_counter()
        for _ in range(3):
            r = rew()
        sync(dev)
        rew_ms = (time.perf_counter() - t0) / 3 * 1e3
        if r.shape != (tc.batch_size, cfg_l.n_goals) or not torch.isfinite(r).all():
            fail(f"[20] get_rewards {tuple(r.shape)}")
        rew_peak = peak()
        reset_peak()
        wall, busy, share = device_busy_share(dev, lambda: ltr.adv_step(generator=lgen))
        adv_peak = peak()
        n_l = tc.rollout_num * cfg_l.n_goals * tc.batch_size
        print(f"[20] get_rewards, {n_l} streams: {rew_ms:.1f} ms (mean of 3, peak memory "
              f"{rew_peak}); an adv step {busy_line(wall, busy, share)}, peak memory "
              f"{adv_peak}  [{card}]", flush=True)
        pre_batch = torch.from_numpy(corpus[:tc.batch_size]).long().to(dev)
        wall, busy, share = device_busy_share(dev, lambda: ltr.pre_step(
            pre_batch, generator=lgen, dropout_generator=lgen))
        print(f"[20] a pre step: {busy_line(wall, busy, share)}  [{card}]", flush=True)

        print(f"    (phase 20 at {time.perf_counter() - t_phase:.1f} s)", flush=True)
        # card against CPU at the tiny config: get_rewards, one adv step, eval_nll
        tiny_l = leakgan_train.LeakGanTrainConfig(
            cfg=lg.LeakGanConfig(vocab_size=40, seq_len=10, step_size=5, goal_size=4,
                                 worker_emb_dim=8, worker_hidden=8, manager_hidden=8,
                                 dis_emb_dim=8, filter_sizes=(1, 2, 3), num_filters=(8, 8, 16)),
            batch_size=4, rollout_num=3)
        pair = [leakgan_train.LeakGanTrainer(tiny_l, seed=20, device=d) for d in ("cpu", dev)]
        noise_gen = torch.Generator().manual_seed(200)
        n_t = 3 * 2 * 4
        toks = torch.randint(0, 40, (4, 10), generator=noise_gen)
        r_noise = gumbel_noise(noise_gen, (10, n_t, 40))
        rewards = [lg.get_rewards(t.g_params, t.d_params, toks.to(t.device), cfg=tiny_l.cfg,
                                  rollout_num=3, noise=r_noise).cpu() for t in pair]
        err_r = float((rewards[0] - rewards[1]).abs().max())
        if err_r > 1e-5:
            fail(f"[20] get_rewards on the card and the CPU differ by {err_r:.3g}")
        adv_noise = gumbel_noise(noise_gen, (11, 4, 40))
        mask = torch.rand((11, 4, 32), generator=noise_gen) < 0.8
        losses = [t.adv_step(adv_noise=adv_noise, rollout_noise=r_noise, dropout_mask=mask)
                  for t in pair]
        err_p = tree_close("[20] adv_step params", pair[1].g_params, pair[0].g_params, 1e-5)
        err_o = tree_close("[20] adv_step Adam states", (pair[1].m_opt, pair[1].w_opt),
                           (pair[0].m_opt, pair[0].w_opt), 1e-5)
        data = torch.randint(0, 40, (8, 10), generator=noise_gen).numpy()
        e_noise = [gumbel_noise(noise_gen, (11, 4, 40)) for _ in range(2)]
        nll = [t.eval_nll(data, noise=e_noise) for t in pair]
        if abs(nll[0] - nll[1]) > 1e-5 or not np.isfinite([*map(float, losses[1]), *nll]).all():
            fail(f"[20] eval_nll card {nll[1]} vs CPU {nll[0]}")
        print(f"[20] tiny config, card vs CPU on the same weights, noise and masks: "
              f"get_rewards within {err_r:.2g}, adv_step params within {err_p:.2g} and Adam "
              f"states within {err_o:.2g} of their scale (tolerance 1e-5), eval_nll "
              f"{nll[1]:.6f} vs {nll[0]:.6f}", flush=True)
        seconds["20"] = time.perf_counter() - t_phase
    finally:
        os.chdir(cwd)
    print(f"[20] the GAN phases 19-20 took {sum(seconds.values()):.1f} s ("
          + ", ".join(f"{k}: {v:.1f} s" for k, v in seconds.items()) + ")", flush=True)
    return seconds


def main() -> None:
    t_run = time.perf_counter()
    if not (ROOT / "music_tpu_torch").is_dir():
        fail(f"run from the root of a checkout (no music_tpu_torch/ beside {__file__})")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from music_tpu_torch import cli
    from music_tpu_torch.core import checkpoint, metrics, optim
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.data import wavio
    from music_tpu_torch.data.audio import AudioWindows
    from music_tpu_torch.generate import wavenet_generate
    from music_tpu_torch.generate.serving import AEDecodeSession, DecodeSession
    from music_tpu_torch.generate.wavenet_generate import stream_tiling, streams_weights
    from music_tpu_torch.kernels import _build
    from music_tpu_torch.kernels import wavenet_ae_decode as aedec
    from music_tpu_torch.kernels import wavenet_ae_decode_hbm as aehbm
    from music_tpu_torch.kernels import wavenet_decode as dec
    from music_tpu_torch.kernels import wavenet_decode_hbm as hbm
    from music_tpu_torch.models import wavenet as wn
    from music_tpu_torch.models import wavenet_ae as ae
    from music_tpu_torch.ops.conv import full_fp32
    from music_tpu_torch.ops.mulaw import mu_law_encode
    from music_tpu_torch.train import wavenet_train
    from music_tpu_torch.utils.parity import (
        ae_reference_scores, ae_teacher_forced_scores, reference_scores,
        teacher_forced_scores, tie_aware_check,
    )

    dev = torch.device("cuda")
    # -- 1. identity
    card = card_identity()
    print(card)  # name and power limit, as nvidia-smi gives them
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build every kernel, one nvcc per source, all at once; meanwhile
    # start torch.profiler (its first use starts CUPTI, ~10 s on the H100
    # host), which phases 19-20 use for the device's busy share
    t0 = time.perf_counter()
    built = {}

    def build():  # nvcc's subprocesses, waited on by a thread of their own
        try:
            _build.build([*KERNELS, PROBE])
        except BaseException as e:  # re-raised by the main thread
            built["error"] = e

    build_thread = threading.Thread(target=build)
    build_thread.start()
    profiler_s = start_profiler()  # in the main thread, which profiles later
    build_thread.join()
    if "error" in built:
        raise built["error"]
    for module in (dec, aedec, hbm, aehbm):
        module._library()
    print(f"[2] built {len(KERNELS) + 1} libraries in {time.perf_counter() - t0:.1f} s; "
          f"torch.profiler started beside them in {profiler_s:.1f} s")
    for name in (*KERNELS, PROBE):
        lib_path = _build.library_path(name)
        built = _build.BUILD_SECONDS.get(name)
        print(f"[2] {lib_path.name}: "
              f"{f'nvcc {built:.1f} s' if built is not None else 'reused an existing build'}")
        log = lib_path.with_suffix(".log")
        if log.exists():  # one line per library: registers and spills of its kernels
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", text))
            if regs:
                print(f"[2] ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                      f"registers, {spills} bytes of spills")
    sys.stdout.flush()

    worst_deficit = dict.fromkeys(KERNELS, 0.0)  # vs the plain version at its precision
    floors = []  # every timed case: (label, kernel ms a step, bytes a block moves a step)

    def check(name, tokens, scores_fn, tol, *, kernel=None):
        """Tie-aware check; with ``kernel``, a check at that kernel's own
        precision, whose deficit counts into its ``max_abs_err``."""
        report = tie_aware_check(tokens, scores_fn, tol)
        if kernel is not None:
            worst_deficit[kernel] = max(worst_deficit[kernel], -report["min_margin"])
        print(f"    {name}: tie-aware {report}", flush=True)
        if not report["ok"]:
            fail(f"{name}: a token scores {-report['min_margin']:.3g} below the plain "
                 f"maximum (tolerance {tol})")

    def model_scores(params, prime, cfg, **sampling):
        """The f32 model's teacher-forced scores (+ the decode's Philox noise)."""
        return lambda t: teacher_forced_scores(params, prime, t.to(dev), cfg, **sampling)

    def logit_error_check(name, plain, f32, tol):
        """``plain``: bf16 plain logits, ``f32``: the f32 model's, along the
        same tokens; a token's tie-aware deficit against the f32 model is at
        most twice their largest difference, which must stay within ``tol``."""
        err = float((plain - f32).abs().max())
        print(f"    {name}: bf16 plain vs f32 model, max logit error {err:.3g}", flush=True)
        if 2 * err > tol:
            fail(f"{name}: bf16 logit error {err:.3g} exceeds half the tolerance {tol}")

    def bf16_logit_error(name, cfg, params, prime, inputs, tokens):
        plain = reference_scores(inputs, tokens, cfg, dtype=torch.bfloat16)
        logit_error_check(name, plain, teacher_forced_scores(params, prime, tokens, cfg)[:, 1:],
                          TOL_BF16)

    def timed(fn, n_steps, reps):
        fn(max(2, n_steps // 8))  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(n_steps)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps / (n_steps - 1)  # ms per decode step

    def reset_counts():
        for module in (dec, aedec, hbm, aehbm):
            module.LAUNCHES = 0

    # -- 3. kernel vs plain on the card, tiny config
    tiny = wn.WaveNetConfig(dilations=(1, 2, 4, 8, 1, 2, 4, 8), dilation_channels=8,
                            residual_channels=8, skip_channels=16, quantization_channels=32)
    cases = [  # (label, rows, streams per block, dtype, mode)
        ("f32 argmax 1 stream", 1, 1, torch.float32, "argmax"),
        ("f32 argmax 11 streams (2 x 8)", 11, 8, torch.float32, "argmax"),
        ("bf16 argmax 16 streams", 16, 16, torch.bfloat16, "argmax"),
        ("f32 categorical 11 streams (2 x 8)", 11, 8, torch.float32, "categorical"),
    ]
    g = torch.Generator().manual_seed(1234)
    params = wn.init_params(tiny, g, device=dev)
    P = tiny.receptive_field + max(tiny.dilations)
    for label, rows, S, dtype, mode in cases:
        prime = torch.randint(0, 32, (rows, P), generator=g).to(dev, torch.int32)
        groups = -(-rows // S)
        sampling = dict(sample_mode=mode, temperature=0.9, seed=77)
        inputs = dec.prepare(params, prime, cfg=tiny, n_streams=S, n_stream_groups=groups,
                             dtype=dtype, **sampling)
        kw = dict(cfg=tiny, n_steps=300, dtype=dtype, **sampling)
        ker = dec.decode_cuda(*inputs, n_streams=S, **kw)
        torch.cuda.synchronize()
        ref = dec.decode_reference(*inputs, **kw)
        exact = int((ker == ref).sum())
        print(f"[3] {label}: kernel == plain on {exact}/{ker.numel()} tokens")
        if exact != ker.numel():
            fail(f"{label}: the kernel differs from its plain version on "
                 f"{ker.numel() - exact} tokens")
        if dtype == torch.float32:
            check(label, ker[:rows], model_scores(params, prime, tiny, **sampling), TOL_F32,
                  kernel="wavenet_decode")
        else:
            check(f"{label} vs the f32 model", ker, model_scores(params, prime, tiny, **sampling),
                  TOL_BF16)
            bf16_logit_error(label, tiny, params, prime, inputs, ker)

    # -- 4. the main path at the shipped width, through the CLI
    params_root = ROOT / "music_tpu_torch" / "params"
    cfg_json = load_params_dir(params_root / "wavenet")["wavenet_params"]
    full = wn.WaveNetConfig.from_json(cfg_json)
    full_params = wn.init_params(full, torch.Generator().manual_seed(0))
    n_params = sum(v.numel() for v in full_params.values())
    print(f"[4] shipped config: {full.n_blocks} blocks, Cr={full.residual_channels}, "
          f"Cs={full.skip_channels}, Q={full.quantization_channels}, "
          f"receptive field {full.receptive_field}, {n_params} params")
    n_samples = int(0.25 * 16000)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        checkpoint.save(tmp / "ckpt", 1, TrainState(params=full_params, step=1))
        runs = [
            ("one stream", ["--out", str(tmp / "one.wav")], [tmp / "one.wav"]),
            ("32 streams", ["--out", str(tmp / "many.wav"), "--num", "32",
                            "--sample-mode", "categorical"],
             [tmp / "many" / f"gen_{i:03d}.wav" for i in range(32)]),
        ]
        codes, walls = {}, {}
        reset_counts()
        for label, extra, wavs in runs:
            before = dec.LAUNCHES
            t0 = time.perf_counter()
            cli.main(["wavenet", "generate", "--checkpoint", str(tmp / "ckpt"),
                      "--duration", "0.25", *extra])
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            if dec.LAUNCHES <= before:
                fail(f"CLI {label}: the decode kernel was not launched")
            codes[label] = np.stack([pcm_codes(w, full.quantization_channels) for w in wavs])
            if codes[label].shape != (len(wavs), n_samples):
                fail(f"CLI {label}: wavs of shape {codes[label].shape}, want {n_samples} samples")
            print(f"[4] CLI {label}: {len(wavs)} wav(s) of {n_samples} samples, "
                  f"{dec.LAUNCHES - before} kernel launch(es), {walls[label]:.2f} s wall "
                  "(includes loading and priming)", flush=True)
        main_path_launches = {"wavenet_decode": dec.LAUNCHES}
    fp = {k: v.to(dev) for k, v in full_params.items()}
    silence = torch.full((32, full.receptive_field + max(full.dilations)),
                         full.quantization_channels // 2, dtype=torch.int32, device=dev)
    one = torch.from_numpy(codes["one stream"][:, :512]).to(dev)
    check("CLI one stream f32, first 512 steps", one, model_scores(fp, silence[:1], full),
          TOL_F32, kernel="wavenet_decode")
    many = torch.from_numpy(codes["32 streams"][:, :512]).to(dev)
    if len({tuple(r) for r in codes["32 streams"].tolist()}) != 32:
        fail("the 32 categorical streams are not distinct")
    # the plain version has the kernel's bf16 rounding points and Philox
    # draws, so the kernel is held to it at the f32 tolerance
    s32, g32 = stream_tiling(32, dev)
    inputs = dec.prepare(fp, silence, cfg=full, n_streams=s32, n_stream_groups=g32,
                         dtype=torch.bfloat16, sample_mode="categorical")
    check("CLI 32 streams bf16 categorical vs its plain version, first 512 steps",
          many[:, 1:], lambda t: reference_scores(inputs, many, full, dtype=torch.bfloat16,
                                                  sample_mode="categorical"), TOL_F32,
          kernel="wavenet_decode")
    check("CLI 32 streams bf16 categorical vs the f32 model, first 512 steps", many,
          model_scores(fp, silence, full, sample_mode="categorical"), TOL_BF16)
    bf16_logit_error("CLI 32 streams", full, fp, silence, inputs, many)

    # -- 5. times at the main path's shapes
    shapes = [  # (label, CLI run, rows, dtype, mode, streams per block)
        ("1 stream f32 argmax", "one stream", 1, torch.float32, "argmax", 1),
        ("32 streams bf16 categorical", "32 streams", 32, torch.bfloat16, "categorical", s32),
        ("32 streams bf16 categorical, 16 per block", None, 32, torch.bfloat16,
         "categorical", 16),
    ]
    times, bounds = {}, {}
    macs = step_macs(full.n_blocks, full.residual_channels, full.dilation_channels,
                     full.skip_channels, full.quantization_channels)
    for label, run, rows, dtype, mode, S in shapes:
        inputs = dec.prepare(fp, silence[:rows], cfg=full, n_streams=S,
                             n_stream_groups=-(-rows // S), dtype=dtype, sample_mode=mode)
        kw = dict(cfg=full, dtype=dtype, sample_mode=mode)
        ker = timed(lambda n: dec.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, TIMED_REPS)
        plain = timed(lambda n: dec.decode_reference(*inputs, n_steps=n, **kw), PLAIN_STEPS, 1)
        times[label] = (ker, plain)
        # one launch of TIMED_STEPS steps reads every input once (weights,
        # rings, first tokens) and writes the rings and the tokens once
        w, ring, s0, prev0 = inputs
        floors.append((f"B1 {label}", ker, block_step_bytes(w, S, full.n_blocks,
                                                            full.residual_channels)))
        launch_bytes = (nbytes(*w.values(), s0, prev0) + 2 * nbytes(ring.to(dtype))
                        + 4 * rows * TIMED_STEPS)
        bounds[label] = bound(launch_bytes / (TIMED_STEPS - 1), 2 * macs * rows,
                              str(dtype).removeprefix("torch."))
        print(f"[5] {label} ({S} per block, {-(-rows // S)} blocks): kernel "
              f"{ker * 1e3:.1f} us/step = {rows / ker * 1e3:.0f} samples/s; plain "
              f"{plain * 1e3:.1f} us/step = {rows / plain * 1e3:.0f} samples/s; bound "
              f"{bounds[label][0] * 1e3:.3f} us/step ({bounds[label][1]}, "
              f"{100 * bounds[label][0] / ker:.2f}% of the kernel's)  [{card}]", flush=True)
        if run is not None:
            kernel_s = ker * (n_samples - 1) / 1e3
            print(f"[5] CLI {run}: kernel {kernel_s:.3f} s of {walls[run]:.3f} s wall "
                  f"({100 * kernel_s / walls[run]:.0f}%, cold call, timing above)", flush=True)
    b1 = {"times": times["1 stream f32 argmax"], "bound": bounds["1 stream f32 argmax"]}

    # the phase-timed build of the kernel (f32, one stream): block 0's
    # clock64 cycles per phase, as shares of the launch's CUDA-event time
    inputs = dec.prepare(fp, silence[:1], cfg=full, n_streams=1, n_stream_groups=1)
    spans = torch.zeros(len(dec.SPAN_PHASES), dtype=torch.int64, device=dev)
    spanned = timed(lambda n: dec.decode_cuda(*inputs, cfg=full, n_steps=n, n_streams=1,
                                              spans=spans), TIMED_STEPS, 1)
    cycles = spans.tolist()
    print(f"[5] phases of a step, 1 stream f32 (timed build {spanned * 1e3:.1f} us/step, "
          f"{cycles[-1] / (spanned * 1e-3 * (TIMED_STEPS - 1)) / 1e9:.2f} GHz): "
          + ", ".join(f"{name} {spanned * 1e3 * c / cycles[-1]:.2f} us"
                      for name, c in zip(dec.SPAN_PHASES[:-1], cycles))
          + f"  [{card}]", flush=True)

    # the plain step loop (backend="scan") on the card, tiny config: its
    # tokens pass the tie-aware check against the fused path's plain version
    # and against the f32 model
    tiny_silence = torch.full((1, P), tiny.quantization_channels // 2, dtype=torch.int32,
                              device=dev)
    gen_codes = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for backend in ("scan", "fused"):
            path = Path(tmp) / f"{backend}.wav"
            wavenet_generate.generate(cfg=tiny, params=params, out_path=path,
                                      duration=48 / 16000, backend=backend, device="cuda")
            gen_codes[backend] = torch.from_numpy(
                pcm_codes(path, tiny.quantization_channels))[None].to(dev)
    scan = gen_codes["scan"]
    inputs = dec.prepare(params, tiny_silence, cfg=tiny, n_streams=1)
    check("[5] generate(backend='scan') on the card vs the fused path's plain version",
          scan[:, 1:], lambda t: reference_scores(inputs, scan, tiny, dtype=torch.float32),
          TOL_F32)
    check("[5] generate(backend='scan') on the card vs the f32 model", scan,
          model_scores(params, tiny_silence, tiny), TOL_F32)
    print(f"[5] scan and fused generate agree on {int((scan == gen_codes['fused']).sum())}/"
          f"{scan.numel()} tokens", flush=True)

    # -- 6. AE kernel vs plain on the card, tiny config
    ae_tiny = ae.WaveNetAEConfig(
        dilations=(1, 2, 4, 8, 1, 2, 4, 8), en_residual_channel=8, en_dilation_channel=8,
        de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16,
        en_bottleneck_width=12, en_pool_kernel_size=16, quantization_channel=32)
    ae_cases = [  # (label, rows, streams per block, dtype)
        ("f32 1 stream", 1, 1, torch.float32),
        ("f32 11 streams (2 x 8)", 11, 8, torch.float32),
        ("bf16 16 streams", 16, 16, torch.bfloat16),
    ]
    g = torch.Generator().manual_seed(4321)
    ae_params = ae.init_params(ae_tiny, g, device=dev)
    P = ae_tiny.receptive_field + max(ae_tiny.dilations)
    F_TINY = 12  # frames end at time 192: every stream clamps within 300 steps
    for label, rows, S, dtype in ae_cases:
        prime = torch.randint(0, 32, (rows, P), generator=g).to(dev, torch.int32)
        enc = (0.3 * torch.randn((rows, F_TINY, ae_tiny.en_bottleneck_width),
                                 generator=g)).to(dev)
        # per-stream clocks: streams cross frame boundaries at different steps
        pos = torch.tensor([0, 5, 17, 3, 30, 11, 24, 9, 1, 14, 28, 6, 19, 2, 25, 13][:rows],
                           dtype=torch.int32, device=dev)
        inputs = aedec.prepare(ae_params, enc, prime, cfg=ae_tiny, n_streams=S,
                               n_stream_groups=-(-rows // S), dtype=dtype, pos_offset=pos)
        kw = dict(cfg=ae_tiny, n_steps=300, dtype=dtype)
        ker = aedec.decode_cuda(*inputs, n_streams=S, **kw)
        torch.cuda.synchronize()
        ref = aedec.decode_reference(*inputs, **kw)
        exact = int((ker == ref).sum())
        print(f"[6] AE {label}: kernel == plain on {exact}/{ker.numel()} tokens")
        if exact != ker.numel():
            fail(f"AE {label}: the kernel differs from its plain version on "
                 f"{ker.numel() - exact} tokens")
        ker = ker[:rows]

        def ae_model(t, enc=enc, prime=prime, pos=pos):
            return ae_teacher_forced_scores(ae_params, enc, prime, t.to(dev), ae_tiny,
                                            pos_offset=pos)

        if dtype == torch.float32:
            check(f"AE {label}", ker, ae_model, TOL_F32, kernel="wavenet_ae_decode")
        else:
            check(f"AE {label} vs the f32 model", ker, ae_model, TOL_AE_BF16)
            logit_error_check(f"AE {label}",
                              ae_reference_scores(inputs, ker, ae_tiny, dtype=dtype),
                              ae_model(ker)[:, 1:], TOL_AE_BF16)

    # -- 7. the reconstruction path at the shipped width, through the CLI
    ae_full = ae.WaveNetAEConfig.from_json(
        load_params_dir(params_root / "wavenet_autoencoder")["model_params"])
    ae_full_params = ae.init_params(ae_full, torch.Generator().manual_seed(0))
    n_params = sum(v.numel() for v in ae_full_params.values())
    Q = ae_full.quantization_channel
    print(f"[7] shipped AE config: {ae_full.n_blocks} blocks, Cr={ae_full.de_residual_channel}, "
          f"Cs={ae_full.de_skip_channel}, W={ae_full.en_bottleneck_width}, "
          f"pool={ae_full.en_pool_kernel_size}, Q={Q}, receptive field "
          f"{ae_full.receptive_field}, {n_params} params")
    sr, n_clips = 16000, 32
    rng = np.random.default_rng(7)
    tt = np.arange(sr) / sr
    clips = []
    for _ in range(n_clips):  # 1.0 s seeded sine mixtures
        freqs, amps = rng.uniform(80, 2000, 3), rng.uniform(0.1, 0.3, 3)
        phases = rng.uniform(0, 2 * np.pi, 3)
        clips.append(sum(a * np.sin(2 * np.pi * f * tt + p)
                         for f, a, p in zip(freqs, amps, phases)).astype(np.float32))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        checkpoint.save(tmp / "ckpt", 1, TrainState(params=ae_full_params, step=1))
        for i, clip in enumerate(clips):
            wavio.write_wav(tmp / "clips" / f"clip_{i:03d}.wav", clip, sr)
        # the sources as the CLI reads them (16-bit PCM)
        sources = np.stack([wavio.read_wav(p)[0] for p in sorted((tmp / "clips").glob("*.wav"))])
        ae_runs = [
            ("one clip", tmp / "clips" / "clip_000.wav", [tmp / "one.wav"]),
            ("32 clips", tmp / "clips",
             [tmp / "many" / f"recon_{i:03d}.wav" for i in range(n_clips)]),
        ]
        ae_codes, ae_walls = {}, {}
        reset_counts()
        for label, source, wavs in ae_runs:
            before = aedec.LAUNCHES
            out = tmp / "one.wav" if source.is_file() else tmp / "many.wav"
            t0 = time.perf_counter()
            cli.main(["wavenet-ae", "generate", "--checkpoint", str(tmp / "ckpt"),
                      "--source", str(source), "--out", str(out), "--duration", "0.25"])
            torch.cuda.synchronize()
            ae_walls[label] = time.perf_counter() - t0
            if aedec.LAUNCHES <= before:
                fail(f"AE CLI {label}: the AE decode kernel was not launched")
            ae_codes[label] = np.stack([pcm_codes(w, Q) for w in wavs])
            if ae_codes[label].shape != (len(wavs), n_samples):
                fail(f"AE CLI {label}: wavs of shape {ae_codes[label].shape}, "
                     f"want {n_samples} samples")
            print(f"[7] AE CLI {label}: {len(wavs)} wav(s) of {n_samples} samples, "
                  f"{aedec.LAUNCHES - before} kernel launch(es), {ae_walls[label]:.2f} s wall "
                  "(includes loading, encoding and priming)", flush=True)
        main_path_launches["wavenet_ae_decode"] = aedec.LAUNCHES
        if "jax" in sys.modules or any(m == "music_tpu" or m.startswith("music_tpu.")
                                       for m in sys.modules):
            fail("jax or the JAX package was imported")
    afp = {k: v.to(dev) for k, v in ae_full_params.items()}
    src_codes = mu_law_encode(torch.from_numpy(sources), Q).to(dev)
    with torch.no_grad(), full_fp32():
        ae_enc = ae.encode(afp, src_codes, ae_full)
    ae_P = ae_full.receptive_field + max(ae_full.dilations)
    ae_prime = src_codes[:, :ae_P]
    for label, rows in (("one clip", 1), ("32 clips", n_clips)):
        toks = torch.from_numpy(ae_codes[label][:, :512]).to(dev)
        check(f"AE CLI {label} f32, first 512 steps", toks,
              lambda t, rows=rows: ae_teacher_forced_scores(afp, ae_enc[:rows], ae_prime[:rows],
                                                            t, ae_full),
              TOL_F32, kernel="wavenet_ae_decode")

    # -- 8. AE times at the main path's shapes
    ae_macs = step_macs(ae_full.n_blocks, ae_full.de_residual_channel,
                        ae_full.de_dilation_channel, ae_full.de_skip_channel, Q)
    ae_times, ae_bounds = {}, {}
    for label, run, rows in (("1 stream f32", "one clip", 1),
                             ("32 streams f32", "32 clips", n_clips)):
        S, G = stream_tiling(rows, dev, aedec.max_streams(ae_full))
        inputs = aedec.prepare(afp, ae_enc[:rows], ae_prime[:rows], cfg=ae_full, n_streams=S,
                               n_stream_groups=G)
        kw = dict(cfg=ae_full, dtype=torch.float32)
        ker = timed(lambda n: aedec.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, TIMED_REPS)
        plain = timed(lambda n: aedec.decode_reference(*inputs, n_steps=n, **kw),
                      PLAIN_STEPS, 1)
        ae_times[label] = (ker, plain)
        # one launch reads the weights, rings and first tokens once, and of
        # the tables only the rows of the frames its steps reach; it writes
        # the rings and the tokens once
        w, ring, s0, prev0, cond_fg, cond_post, pos0 = inputs
        floors.append((f"B3 {label}", ker, block_step_bytes(
            w, S, ae_full.n_blocks, ae_full.de_residual_channel,
            cond_fg.shape[2] + cond_post.shape[2])))
        first = ae.frame_of(pos0.long(), ae_full.en_pool_kernel_size, cond_fg.shape[1])
        last = ae.frame_of(pos0.long() + TIMED_STEPS - 2, ae_full.en_pool_kernel_size,
                           cond_fg.shape[1])
        rows_read = int((last - first + 1).sum())
        row_bytes = (cond_fg.shape[2] + cond_post.shape[2]) * cond_fg.element_size()
        launch_bytes = (nbytes(*w.values(), s0, prev0, pos0) + 2 * nbytes(ring)
                        + rows_read * row_bytes + 4 * rows * TIMED_STEPS)
        ae_bounds[label] = bound(launch_bytes / (TIMED_STEPS - 1), 2 * ae_macs * rows, "float32")
        print(f"[8] AE {label} ({S} per block, {G} blocks): kernel {ker * 1e3:.1f} us/step = "
              f"{rows / ker * 1e3:.0f} samples/s; plain {plain * 1e3:.1f} us/step = "
              f"{rows / plain * 1e3:.0f} samples/s; bound {ae_bounds[label][0] * 1e3:.3f} "
              f"us/step ({ae_bounds[label][1]}, {100 * ae_bounds[label][0] / ker:.2f}% of the "
              f"kernel's)  [{card}]", flush=True)
        kernel_s = ker * (n_samples - 1) / 1e3
        print(f"[8] AE CLI {run}: kernel {kernel_s:.3f} s of {ae_walls[run]:.3f} s wall "
              f"({100 * kernel_s / ae_walls[run]:.0f}%, cold call, timing above)", flush=True)
    b3 = {"times": ae_times["1 stream f32"], "bound": ae_bounds["1 stream f32"]}

    # -- 9. the weight-streaming WaveNet kernel vs plain, tiny config, every mode
    f32, bf16, int8 = torch.float32, torch.bfloat16, torch.int8
    g = torch.Generator().manual_seed(999)
    b2_params = wn.init_params(tiny, g, device=dev)
    b2_dq = hbm.dequantized_params(b2_params, tiny)
    calib = torch.randint(0, 32, (2, 600), generator=g).to(dev)
    tiny_act = hbm.calibrate_act_scales(b2_params, tiny, calib)
    P = tiny.receptive_field + max(tiny.dilations)
    b2_tile = hbm.max_streams(tiny)  # the largest working-dtype tile, f32 or bf16: 4
    assert b2_tile == hbm.max_streams(tiny, bf16)
    b2_cases = [  # (label, rows, streams per block, dtype, mode, weight dtype, int8 products, act)
        ("f32 argmax 1 stream", 1, 1, f32, "argmax", None, False, None),
        (f"f32 argmax 11 streams (3 x {b2_tile})", 11, b2_tile, f32, "argmax", None, False,
         None),
        (f"bf16 argmax 16 streams (4 x {b2_tile})", 16, b2_tile, bf16, "argmax", None, False,
         None),
        (f"f32 categorical 11 streams (3 x {b2_tile})", 11, b2_tile, f32, "categorical", None,
         False, None),
        ("int8 weights f32 11 streams", 11, 8, f32, "argmax", int8, False, None),
        ("int8 weights bf16 16 streams", 16, 16, bf16, "argmax", int8, False, None),
        ("int8 products, dynamic scales, 11 streams", 11, 8, f32, "argmax", int8, True, None),
        ("int8 products, static scales, 11 streams", 11, 8, f32, "argmax", int8, True, tiny_act),
    ]
    for label, rows, S, dtype, mode, wd, q8, act in b2_cases:
        prime = torch.randint(0, 32, (rows, P), generator=g).to(dev, torch.int32)
        sampling = dict(sample_mode=mode, temperature=0.9, seed=77)
        model = b2_params if wd is None else b2_dq  # int8 weights: requantizing dq is exact
        inputs = hbm.prepare(model, prime, cfg=tiny, n_streams=S, n_stream_groups=-(-rows // S),
                             dtype=dtype, weight_dtype=wd, int8_matmul=q8, act_scales=act,
                             **sampling)
        kw = dict(cfg=tiny, n_steps=300, dtype=dtype, int8_matmul=q8, **sampling)
        ker = hbm.decode_cuda(*inputs, n_streams=S, **kw)
        torch.cuda.synchronize()
        ref = hbm.decode_reference(*inputs, **kw)
        exact = int((ker == ref).sum())
        print(f"[9] B2 {label}: kernel == plain on {exact}/{ker.numel()} tokens")
        if exact != ker.numel():
            first = (ker != ref).nonzero()[0].tolist()
            fail(f"B2 {label}: the kernel differs from its plain version on "
                 f"{ker.numel() - exact} tokens, first at (row, step) {first}")
        ker = ker[:rows]
        if q8:  # activations quantized: random weights give no agreement to hold
            info = tie_aware_check(ker, model_scores(b2_params, prime, tiny), 1.0)
            print(f"    B2 {label}: the f32 model's argmax on {info['exact']}/{info['n']} "
                  "tokens (information)", flush=True)
        elif dtype == f32:
            check(f"B2 {label}", ker, model_scores(model, prime, tiny, **sampling), TOL_F32,
                  kernel="wavenet_decode_hbm")
        else:
            check(f"B2 {label} vs the f32 model", ker, model_scores(model, prime, tiny, **sampling),
                  TOL_BF16)

    # the tiny model trained on the card by the port's trainer step (Adam, a
    # repeating pattern, loss < 0.1), where int8 products must reproduce the
    # f32 model's tokens
    pat = np.tile(np.arange(8).repeat(3), 400)[: tiny.receptive_field + 256]
    pat_t = torch.from_numpy(pat).to(dev)[None]
    tx = optim.make_optimizer("adam", 1e-2)
    state = wavenet_train.init_state(torch.Generator().manual_seed(0), tiny, tx, dev)
    train_step = wavenet_train.make_train_step(tiny, tx)
    with full_fp32():
        for it in range(1, 601):
            state, loss = train_step(state, pat_t)
            if it >= 120 and loss.item() < 0.1:
                break
    print(f"[9] tiny model trained on the card: loss {loss.item():.4f} after {it} Adam steps")
    if loss.item() >= 0.1:
        fail(f"training the tiny model reached loss {loss.item():.3g}, not < 0.1")
    trained = state.params
    P16 = P + 16
    tprime = pat_t[:, :P16].to(torch.int32)
    with full_fp32():
        want = wn.generate_tokens(trained, tprime, cfg=tiny, n_steps=150, prime_len=P16)
    for label, act in (("dynamic", None),
                       ("static", hbm.calibrate_act_scales(trained, tiny, pat_t))):
        q8 = hbm.generate_tokens_fused_hbm(trained, tprime, cfg=tiny, n_steps=150, n_streams=1,
                                           weight_dtype=int8, int8_matmul=True, act_scales=act)
        agreement = float((q8 == want).float().mean())
        print(f"[9] trained model, int8 products with {label} scales: {agreement:.4f} token "
              "agreement with the f32 model", flush=True)
        if agreement < 0.99:
            fail(f"int8 products ({label}) agree with the f32 model on {agreement:.4f} < 0.99")

    # -- 10. the scaled width: through the CLI one f32 stream (the
    # weight-streaming kernel) and 32 bf16 streams (the resident kernel), and
    # through generate_batch f32 streams past what the resident carve holds
    # in one wave (the weight-streaming kernel, 4 a block)
    scaled_json = {**cfg_json, "residual_channels": 64, "dilation_channels": 64,
                   "skip_channels": 1024}
    scaled = wn.WaveNetConfig.from_json(scaled_json)
    scaled_params = wn.init_params(scaled, torch.Generator().manual_seed(0))
    n_params = sum(v.numel() for v in scaled_params.values())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_past = sms * dec.max_streams(scaled) + 8  # 272 f32 streams on 132 SMs
    print(f"[10] scaled config: {scaled.n_blocks} blocks, Cr=Cd={scaled.residual_channels}, "
          f"Cs={scaled.skip_channels}, {n_params} params, {4 * n_params / 1e6:.2f} MB f32; "
          f"streams a block: resident {dec.max_streams(scaled)} f32 or "
          f"{dec.max_streams(scaled, bf16)} bf16, weight-streaming {hbm.max_streams(scaled)} f32 "
          f"or {hbm.max_streams(scaled, bf16)} bf16 ({hbm.max_streams(scaled, mode=1)} with int8 "
          "weights)")

    def cli_run(*extra):
        return lambda: cli.main(common + list(extra))

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        (tmp / "params").mkdir()
        (tmp / "params" / "wavenet_params.json").write_text(json.dumps(scaled_json))
        checkpoint.save(tmp / "ckpt", 1, TrainState(params=scaled_params, step=1))
        common = ["wavenet", "generate", "--checkpoint", str(tmp / "ckpt"), "--params-dir",
                  str(tmp / "params"), "--duration", "0.25"]
        scaled_codes = {}
        reset_counts()
        for label, run, wavs, kernel in [
            ("CLI one stream", cli_run("--out", str(tmp / "one.wav")), [tmp / "one.wav"], hbm),
            ("CLI 32 streams", cli_run("--out", str(tmp / "many.wav"), "--num", "32",
                                       "--sample-mode", "categorical"),
             [tmp / "many" / f"gen_{i:03d}.wav" for i in range(32)], dec),
            (f"generate_batch {n_past} f32 streams", lambda: wavenet_generate.generate_batch(
                cfg=scaled, checkpoint_dir=tmp / "ckpt", n=n_past, out_dir=tmp / "past",
                duration=0.25, sample_mode="categorical", dtype=f32, device="cuda"),
             [tmp / "past" / f"gen_{i:03d}.wav" for i in range(n_past)], hbm),
        ]:
            before = {m: m.LAUNCHES for m in (dec, hbm)}
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            other = hbm if kernel is dec else dec
            if kernel.LAUNCHES != before[kernel] + 1 or other.LAUNCHES != before[other]:
                fail(f"scaled {label}: {kernel.__name__} was not the one kernel launched")
            scaled_codes[label] = np.stack([pcm_codes(w, 256) for w in wavs])
            if scaled_codes[label].shape != (len(wavs), n_samples):
                fail(f"scaled {label}: wavs of shape {scaled_codes[label].shape}")
            print(f"[10] scaled {label}: {len(wavs)} wav(s) of {n_samples} samples, one "
                  f"launch of {kernel.__name__.rsplit('.', 1)[1]}, {wall:.2f} s wall", flush=True)
        main_path_launches["wavenet_decode"] += dec.LAUNCHES
        main_path_launches["wavenet_decode_hbm"] = hbm.LAUNCHES
    sfp = {k: v.to(dev) for k, v in scaled_params.items()}
    s_sil = torch.full((2 * n_past, scaled.receptive_field + max(scaled.dilations)), 128,
                       dtype=torch.int32, device=dev)
    one = torch.from_numpy(scaled_codes["CLI one stream"][:, :512]).to(dev)
    check("[10] scaled CLI one stream f32, first 512 steps", one,
          model_scores(sfp, s_sil[:1], scaled), TOL_F32, kernel="wavenet_decode_hbm")
    for label in ("CLI 32 streams", f"generate_batch {n_past} f32 streams"):
        if len({tuple(r) for r in scaled_codes[label].tolist()}) != len(scaled_codes[label]):
            fail(f"the scaled {label} (categorical) are not distinct")
    many = torch.from_numpy(scaled_codes["CLI 32 streams"][:, :512]).to(dev)
    inputs = dec.prepare(sfp, s_sil[:32], cfg=scaled, n_streams=32, dtype=bf16,
                         sample_mode="categorical")
    check("[10] scaled CLI 32 streams bf16 categorical vs its plain version, first 512 steps",
          many[:, 1:], lambda t: reference_scores(inputs, many, scaled, dtype=bf16,
                                                  sample_mode="categorical"),
          TOL_F32, kernel="wavenet_decode")
    check("[10] scaled CLI 32 streams bf16 categorical vs the f32 model, first 512 steps", many,
          model_scores(sfp, s_sil[:32], scaled, sample_mode="categorical"), TOL_BF16)
    logit_error_check("[10] scaled CLI 32 streams",
                      reference_scores(inputs, many, scaled, dtype=bf16),
                      teacher_forced_scores(sfp, s_sil[:32], many, scaled)[:, 1:], TOL_BF16)
    past = torch.from_numpy(scaled_codes[f"generate_batch {n_past} f32 streams"][:4, :512])
    check(f"[10] scaled generate_batch {n_past} f32 categorical streams (the first 4) vs the f32 "
          "model, first 512 steps", past.to(dev),
          model_scores(sfp, s_sil[:4], scaled, sample_mode="categorical"), TOL_F32,
          kernel="wavenet_decode_hbm")

    # -- 11. the int8 modes at the scaled width
    rprime = torch.randint(0, 256, s_sil.shape, generator=torch.Generator().manual_seed(11))
    rprime = rprime.to(dev, torch.int32)
    for label, rows, dtype, q8 in [("int8 weights, 1 f32 stream", 1, f32, False),
                                   ("int8 weights, 32 bf16 streams", 32, bf16, False),
                                   ("int8 products, 32 bf16 streams", 32, bf16, True)]:
        S, G = stream_tiling(rows, dev, hbm.max_streams(scaled, dtype, hbm.mode_of(int8, q8)))
        opts = dict(cfg=scaled, n_streams=S, n_stream_groups=G, dtype=dtype, weight_dtype=int8,
                    int8_matmul=q8)
        before = hbm.LAUNCHES
        toks = hbm.generate_tokens_fused_hbm(sfp, rprime[:rows], n_steps=512, **opts)
        torch.cuda.synchronize()
        if hbm.LAUNCHES != before + 1:
            fail(f"[11] {label}: the weight-streaming kernel was not launched once")
        inputs = hbm.prepare(sfp, rprime[:rows], **opts)
        check(f"[11] scaled {label} vs its plain version, 512 steps", toks[:, 1:],
              lambda t, inputs=inputs, toks=toks, dtype=dtype, q8=q8: reference_scores(
                  inputs, toks, scaled, dtype=dtype, kernel=hbm, int8_matmul=q8),
              TOL_F32, kernel="wavenet_decode_hbm")
        info = tie_aware_check(toks, model_scores(sfp, rprime[:rows], scaled), 1.0)
        print(f"    [11] scaled {label}: the f32 model's argmax on {info['exact']}/{info['n']} "
              "tokens (information)", flush=True)

    # -- 12. the weight-streaming AE kernel vs plain, tiny config
    g = torch.Generator().manual_seed(4444)
    b4_params = ae.init_params(ae_tiny, g, device=dev)
    b4_dq = aehbm.dequantized_params(b4_params, ae_tiny)
    P = ae_tiny.receptive_field + max(ae_tiny.dilations)
    b4_tile = aehbm.max_streams(ae_tiny, bf16)  # the largest working-dtype tile: 4
    for label, rows, S, dtype, wd in [("f32 1 stream", 1, 1, f32, None),
                                      (f"f32 11 streams (3 x {b4_tile})", 11, b4_tile, f32, None),
                                      (f"bf16 16 streams (4 x {b4_tile})", 16, b4_tile, bf16,
                                       None),
                                      ("int8 weights f32 11 streams", 11, 8, f32, int8)]:
        prime = torch.randint(0, 32, (rows, P), generator=g).to(dev, torch.int32)
        enc = (0.3 * torch.randn((rows, F_TINY, ae_tiny.en_bottleneck_width),
                                 generator=g)).to(dev)
        pos = torch.tensor([0, 5, 17, 3, 30, 11, 24, 9, 1, 14, 28, 6, 19, 2, 25, 13][:rows],
                           dtype=torch.int32, device=dev)
        model = b4_params if wd is None else b4_dq
        inputs = aehbm.prepare(model, enc, prime, cfg=ae_tiny, n_streams=S,
                               n_stream_groups=-(-rows // S), dtype=dtype, weight_dtype=wd,
                               pos_offset=pos)
        kw = dict(cfg=ae_tiny, n_steps=300, dtype=dtype)
        ker = aehbm.decode_cuda(*inputs, n_streams=S, **kw)
        torch.cuda.synchronize()
        ref = aehbm.decode_reference(*inputs, **kw)
        exact = int((ker == ref).sum())
        print(f"[12] B4 {label}: kernel == plain on {exact}/{ker.numel()} tokens")
        if exact != ker.numel():
            fail(f"B4 {label}: the kernel differs from its plain version on "
                 f"{ker.numel() - exact} tokens")

        def b4_model(t, model=model, enc=enc, prime=prime, pos=pos):
            return ae_teacher_forced_scores(model, enc, prime, t.to(dev), ae_tiny,
                                            pos_offset=pos)

        if dtype == f32:
            check(f"[12] B4 {label}", ker[:rows], b4_model, TOL_F32,
                  kernel="wavenet_ae_decode_hbm")
        else:
            check(f"[12] B4 {label} vs the f32 model", ker[:rows], b4_model, TOL_AE_BF16)

    # -- 13. the AE at the scaled decoder width through the CLI: 1 and 32
    # clips and a count past what the resident carve holds in one wave (0.3 s
    # clips), all on the weight-streaming kernel
    ae_scaled_json = {**load_params_dir(params_root / "wavenet_autoencoder")["model_params"],
                      "de_residual_channel": 64, "de_dilation_channel": 64,
                      "de_skip_channel": 1024}
    ae_scaled = ae.WaveNetAEConfig.from_json(ae_scaled_json)
    ae_scaled_params = ae.init_params(ae_scaled, torch.Generator().manual_seed(0))
    dec_params = sum(ae_scaled_params[k].numel() for k in aehbm.DECODER_KEYS)
    n_past_ae = sms * aedec.max_streams(ae_scaled) + 8  # 272 on 132 SMs
    print(f"[13] scaled AE decoder: Cr=Cd={ae_scaled.de_residual_channel}, "
          f"Cs={ae_scaled.de_skip_channel}, {dec_params} decoder params in the kernel "
          f"({4 * dec_params / 1e6:.2f} MB f32); f32 streams a block: resident "
          f"{aedec.max_streams(ae_scaled)}, weight-streaming {aehbm.max_streams(ae_scaled)}")
    t_past = np.arange(int(0.3 * sr)) / sr
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        (tmp / "params").mkdir()
        (tmp / "params" / "model_params.json").write_text(json.dumps(ae_scaled_json))
        checkpoint.save(tmp / "ckpt", 1, TrainState(params=ae_scaled_params, step=1))
        for i, clip in enumerate(clips):
            wavio.write_wav(tmp / "clips" / f"clip_{i:03d}.wav", clip, sr)
        for i in range(n_past_ae):  # 0.3 s seeded sine mixtures
            freqs, amps = rng.uniform(80, 2000, 3), rng.uniform(0.1, 0.3, 3)
            clip = sum(a * np.sin(2 * np.pi * f * t_past) for f, a in zip(freqs, amps))
            wavio.write_wav(tmp / "past_clips" / f"clip_{i:03d}.wav", clip.astype(np.float32), sr)
        past_sources = np.stack([wavio.read_wav(tmp / "past_clips" / f"clip_{i:03d}.wav")[0]
                                 for i in range(4)])
        ae_scaled_codes = {}
        reset_counts()
        for label, source, wavs, kernel in [
            ("one clip", tmp / "clips" / "clip_000.wav", [tmp / "one.wav"], aehbm),
            ("32 clips", tmp / "clips",
             [tmp / "many" / f"recon_{i:03d}.wav" for i in range(n_clips)], aehbm),
            (f"{n_past_ae} clips", tmp / "past_clips",
             [tmp / "past" / f"recon_{i:03d}.wav" for i in range(n_past_ae)], aehbm),
        ]:
            before = {m: m.LAUNCHES for m in (aedec, aehbm)}
            out = tmp / ("one.wav" if source.is_file() else f"{wavs[0].parent.name}.wav")
            t0 = time.perf_counter()
            cli.main(["wavenet-ae", "generate", "--checkpoint", str(tmp / "ckpt"),
                      "--params-dir", str(tmp / "params"), "--source", str(source),
                      "--out", str(out), "--duration", "0.25"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            other = aehbm if kernel is aedec else aedec
            if kernel.LAUNCHES != before[kernel] + 1 or other.LAUNCHES != before[other]:
                fail(f"scaled AE CLI {label}: {kernel.__name__} was not the one kernel launched")
            ae_scaled_codes[label] = np.stack([pcm_codes(w, Q) for w in wavs])
            if ae_scaled_codes[label].shape != (len(wavs), n_samples):
                fail(f"scaled AE CLI {label}: wavs of shape {ae_scaled_codes[label].shape}")
            print(f"[13] scaled AE CLI {label}: {len(wavs)} wav(s) of {n_samples} samples, one "
                  f"launch of {kernel.__name__.rsplit('.', 1)[1]}, {wall:.2f} s wall",
                  flush=True)
        main_path_launches["wavenet_ae_decode"] += aedec.LAUNCHES
        main_path_launches["wavenet_ae_decode_hbm"] = aehbm.LAUNCHES
    asp = {k: v.to(dev) for k, v in ae_scaled_params.items()}
    past_codes = mu_law_encode(torch.from_numpy(past_sources), Q).to(dev)
    with torch.no_grad(), full_fp32():
        as_enc = ae.encode(asp, src_codes, ae_scaled)
        past_enc = ae.encode(asp, past_codes, ae_scaled)
    as_P = ae_scaled.receptive_field + max(ae_scaled.dilations)
    as_prime = src_codes[:, :as_P]
    for label, enc_, prime_, rows, name in (
            ("one clip", as_enc, as_prime, 1, "wavenet_ae_decode_hbm"),
            ("32 clips", as_enc, as_prime, n_clips, "wavenet_ae_decode_hbm"),
            (f"{n_past_ae} clips", past_enc, past_codes[:, :as_P], 4, "wavenet_ae_decode_hbm")):
        toks = torch.from_numpy(ae_scaled_codes[label][:rows, :512]).to(dev)
        what = "" if rows == len(ae_scaled_codes[label]) else f" (the first {rows})"
        check(f"[13] scaled AE CLI {label}{what} f32, first 512 steps", toks,
              lambda t, enc_=enc_, prime_=prime_, rows=rows: ae_teacher_forced_scores(
                  asp, enc_[:rows], prime_[:rows], t, ae_scaled),
              TOL_F32, kernel=name)
    S, G = stream_tiling(n_clips, dev, aehbm.max_streams(ae_scaled, mode=1))
    opts = dict(cfg=ae_scaled, n_streams=S, n_stream_groups=G, weight_dtype=int8)
    toks = aehbm.generate_tokens_fused_hbm(asp, as_enc, as_prime, n_steps=512, **opts)
    inputs = aehbm.prepare(asp, as_enc, as_prime, **opts)
    check("[13] scaled AE int8 weights, 32 clips vs its plain version, 512 steps", toks[:, 1:],
          lambda t: ae_reference_scores(inputs, toks, ae_scaled, dtype=f32, kernel=aehbm),
          TOL_F32, kernel="wavenet_ae_decode_hbm")

    # -- 14. times of the weight-streaming kernels at the scaled width (the
    # plain versions at the main path's one-a-block tiles only)
    scaled_macs = step_macs(scaled.n_blocks, scaled.residual_channels,
                            scaled.dilation_channels, scaled.skip_channels,
                            scaled.quantization_channels)
    hbm_times = {}
    for label, rows, dtype, mode, wd, q8 in [
        ("1 stream f32", 1, f32, "argmax", None, False),
        ("32 streams bf16 categorical", 32, bf16, "categorical", None, False),
        (f"{n_past} streams f32 categorical", n_past, f32, "categorical", None, False),
        (f"{2 * n_past} streams bf16 categorical", 2 * n_past, bf16, "categorical", None, False),
        ("32 streams bf16 int8 weights", 32, bf16, "categorical", int8, False),
        ("32 streams bf16 int8 products", 32, bf16, "categorical", int8, True),
    ]:
        S, G = stream_tiling(rows, dev, hbm.max_streams(scaled, dtype, hbm.mode_of(wd, q8)))
        inputs = hbm.prepare(sfp, s_sil[:rows], cfg=scaled, n_streams=S, n_stream_groups=G,
                             dtype=dtype, weight_dtype=wd, int8_matmul=q8, sample_mode=mode)
        kw = dict(cfg=scaled, dtype=dtype, int8_matmul=q8, sample_mode=mode)
        ker = timed(lambda n: hbm.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, TIMED_REPS)
        plain = None if rows > 32 else timed(
            lambda n: hbm.decode_reference(*inputs, n_steps=n, **kw), PLAIN_STEPS_SCALED, 1)
        w, ring, s0, prev0 = inputs
        floors.append((f"B2 {label}", ker, block_step_bytes(w, S, scaled.n_blocks,
                                                            scaled.residual_channels)))
        launch_bytes = (nbytes(*model_packs(w).values(), s0, prev0) + 2 * nbytes(ring.to(dtype))
                        + 4 * rows * TIMED_STEPS)
        peak = "int8" if q8 else str(dtype).removeprefix("torch.")
        hbm_times[label] = (ker, plain, bound(launch_bytes / (TIMED_STEPS - 1),
                                              2 * scaled_macs * rows, peak))
        print(f"[14] B2 {label} ({S} per block, {G} blocks): "
              + rate_line(rows, ker, plain, hbm_times[label][2]) + f"  [{card}]", flush=True)
    # the AE past the resident carve: the first 4 clips' encodings and primes, repeated
    past_rep = -(-n_past_ae // 4)
    past_args = (past_enc.repeat(past_rep, 1, 1)[:n_past_ae],
                 past_codes[:, :as_P].repeat(past_rep, 1)[:n_past_ae])
    for label, rows, wd in [("1 stream f32", 1, None), ("32 streams f32", n_clips, None),
                            (f"{n_past_ae} streams f32", n_past_ae, None),
                            ("32 streams f32 int8 weights", n_clips, int8)]:
        S, G = stream_tiling(rows, dev, aehbm.max_streams(ae_scaled, f32, hbm.mode_of(wd)))
        enc_, prime_ = past_args if rows > n_clips else (as_enc[:rows], as_prime[:rows])
        inputs = aehbm.prepare(asp, enc_, prime_, cfg=ae_scaled, n_streams=S,
                               n_stream_groups=G, weight_dtype=wd)
        kw = dict(cfg=ae_scaled, dtype=f32)
        ker = timed(lambda n: aehbm.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, TIMED_REPS)
        plain = None if rows > n_clips else timed(
            lambda n: aehbm.decode_reference(*inputs, n_steps=n, **kw), PLAIN_STEPS_SCALED, 1)
        w, ring, s0, prev0, cond_fg, cond_post, pos0 = inputs
        floors.append((f"B4 {label}", ker, block_step_bytes(
            w, S, ae_scaled.n_blocks, ae_scaled.de_residual_channel,
            cond_fg.shape[2] + cond_post.shape[2])))
        pool, F = ae_scaled.en_pool_kernel_size, cond_fg.shape[1]
        rows_read = int((ae.frame_of(pos0.long() + TIMED_STEPS - 2, pool, F)
                         - ae.frame_of(pos0.long(), pool, F) + 1).sum())
        row_bytes = (cond_fg.shape[2] + cond_post.shape[2]) * cond_fg.element_size()
        launch_bytes = (nbytes(*model_packs(w).values(), s0, prev0, pos0) + 2 * nbytes(ring)
                        + rows_read * row_bytes + 4 * rows * TIMED_STEPS)
        hbm_times["AE " + label] = (ker, plain, bound(launch_bytes / (TIMED_STEPS - 1),
                                                      2 * scaled_macs * rows, "float32"))
        print(f"[14] B4 {label} ({S} per block, {G} blocks): "
              + rate_line(rows, ker, plain, hbm_times["AE " + label][2]) + f"  [{card}]", flush=True)

    # the phase-timed build of the WaveNet kernel's working-dtype mode (f32,
    # one stream): block 0's clock64 cycles per phase, as shares of the
    # launch's CUDA-event time
    inputs = hbm.prepare(sfp, s_sil[:1], cfg=scaled, n_streams=1)
    spans = torch.zeros(len(hbm.SPAN_PHASES), dtype=torch.int64, device=dev)
    spanned = timed(lambda n: hbm.decode_cuda(*inputs, cfg=scaled, n_steps=n, n_streams=1,
                                              spans=spans), TIMED_STEPS, 1)
    cycles = spans.tolist()
    print(f"[14] B2 phases of a step, 1 stream f32 (timed build {spanned * 1e3:.1f} us/step, "
          f"{cycles[-1] / (spanned * 1e-3 * (TIMED_STEPS - 1)) / 1e9:.2f} GHz): "
          + ", ".join(f"{name} {spanned * 1e3 * c / cycles[-1]:.2f} us"
                      for name, c in zip(hbm.SPAN_PHASES[:-1], cycles))
          + f"  [{card}]", flush=True)

    # the routing rule's two sides, kernels only: on the same rows, each
    # kernel tiled by its own max_streams, the one timed above against the
    # other; every f32 case of fewer than 33 rows first checked tie-aware
    # against the f32 model over 512 steps
    def versus(label, name, mod, cfg_, args, dtype, opts, model_fn, other):
        rows = args[-1].shape[0]
        S, G = stream_tiling(rows, dev, mod.max_streams(cfg_, dtype))
        inputs = mod.prepare(*args, cfg=cfg_, n_streams=S, n_stream_groups=G, dtype=dtype, **opts)
        kw = dict(cfg=cfg_, dtype=dtype, **opts)
        if model_fn is not None:
            toks = mod.decode_cuda(*inputs, n_steps=512, n_streams=S, **kw)[:rows]
            check(f"[14] {name} at the {label}, 512 steps", toks, model_fn, TOL_F32)
        ker = timed(lambda n: mod.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, TIMED_REPS)
        resident, streaming = (dec, hbm) if mod in (dec, hbm) else (aedec, aehbm)
        names = ("B3", "B4") if resident is aedec else ("B1", "B2")
        pick = names[streams_weights(rows, dev, resident, streaming, cfg_, dtype)]
        faster = name if ker < other[1] else other[0]
        print(f"[14] routing, {label}: {name} ({S} per block, {G} blocks) {ker * 1e3:.1f} "
              f"us/step, {other[0]} {other[1] * 1e3:.1f} us/step; the rule picks {pick}, "
              f"{faster} is faster  [{card}]", flush=True)

    def ae_model_scores(params_, enc, prime_, cfg_):
        return lambda t: ae_teacher_forced_scores(params_, enc, prime_, t.to(dev), cfg_)

    cat = {"sample_mode": "categorical"}
    versus("scaled width, 1 stream f32", "B1", dec, scaled, (sfp, s_sil[:1]), f32, {},
           model_scores(sfp, s_sil[:1], scaled), ("B2", hbm_times["1 stream f32"][0]))
    versus("scaled width, 32 streams bf16 categorical", "B1", dec, scaled, (sfp, s_sil[:32]),
           bf16, cat, None, ("B2", hbm_times["32 streams bf16 categorical"][0]))
    for rows, dtype, name in ((n_past, f32, "f32"), (2 * n_past, bf16, "bf16")):  # past the carve
        key = f"{rows} streams {name} categorical"
        versus(f"scaled width, {key}", "B1", dec, scaled, (sfp, s_sil[:rows]), dtype, cat, None,
               ("B2", hbm_times[key][0]))
    versus("shipped width, 1 stream f32", "B2", hbm, full, (fp, silence[:1]), f32, {},
           model_scores(fp, silence[:1], full), ("B1", times["1 stream f32 argmax"][0]))
    versus("shipped width, 32 streams bf16 categorical", "B2", hbm, full, (fp, silence), bf16,
           cat, None, ("B1", times["32 streams bf16 categorical"][0]))
    for rows, key in ((1, "1 stream f32"), (n_clips, "32 streams f32"),
                      (n_past_ae, f"{n_past_ae} streams f32")):
        enc_, prime_ = past_args if rows > n_clips else (as_enc[:rows], as_prime[:rows])
        versus(f"scaled AE decoder, {key}", "B3", aedec, ae_scaled, (asp, enc_, prime_), f32, {},
               None if rows > n_clips else ae_model_scores(asp, enc_, prime_, ae_scaled),
               ("B4", hbm_times["AE " + key][0]))
    for rows, key in ((1, "1 stream f32"), (n_clips, "32 streams f32")):
        versus(f"shipped AE, {key}", "B4", aehbm, ae_full,
               (afp, ae_enc[:rows], ae_prime[:rows]), f32, {},
               ae_model_scores(afp, ae_enc[:rows], ae_prime[:rows], ae_full),
               ("B3", ae_times[key][0]))
    b2 = {"times": hbm_times["1 stream f32"], "bound": hbm_times["1 stream f32"][2]}
    b4 = {"times": hbm_times["AE 1 stream f32"], "bound": hbm_times["AE 1 stream f32"][2]}
    if "jax" in sys.modules or any(m == "music_tpu" or m.startswith("music_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported")

    # -- 15. one block's L2 read rate (csrc/l2_probe.cu) at the bytes each
    # timed case's blocks move a step, and that case's one-SM floor: those
    # bytes over that rate (every block re-reads its weights each step)
    probe = ctypes.CDLL(str(_build.library_path(PROBE)))
    probe.l2_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    probe.l2_probe.restype = ctypes.c_int
    sink = torch.empty(512, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for size in sorted({-(-b // 16) * 16 for _, _, b in floors}):
        data = torch.ones(size // 4, device=dev)
        ms = []  # the first launch brings the array into L2; the fastest of the rest counts
        for _ in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if probe.l2_probe(data.data_ptr(), size // 16, PROBE_REPS, sink.data_ptr(), stream):
                fail("the L2 probe did not launch")
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        rates[size] = PROBE_REPS * size / (min(ms[1:]) * 1e-3)
        print(f"[15] L2 probe, one block reads {size} B: {rates[size] / 1e9:.1f} GB/s  [{card}]",
              flush=True)
        del data
    for label, ker, b in floors:
        rate = rates[-(-b // 16) * 16]
        print(f"[15] {label}: kernel {ker * 1e3:.1f} us/step, one-SM floor "
              f"{b / rate * 1e6:.1f} us/step ({b} B a block at {rate / 1e9:.1f} GB/s), "
              f"kernel {ker * 1e-3 * rate / b:.2f}x the floor  [{card}]", flush=True)

    # -- 16. train -> checkpoint at the shipped width: a dataset of seeded
    # sine mixtures through the CLI's `dataset build-audio`, `wavenet train`
    # for two epochs of the shipped dataset params (window 40000, batch 4;
    # learning rate 1e-3), resumed for one more; then the trainer's step
    # timed in f32 and with compute_dtype bf16, and `wavenet-ae train` for
    # one epoch
    t_new = time.perf_counter()
    shipped = load_params_dir(params_root / "wavenet")
    shipped_ae = load_params_dir(params_root / "wavenet_autoencoder")
    new_phase_s = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(16)
        t_song = np.arange(20 * sr + sr // 10) / sr
        for i in range(2):  # two songs of 20.1 s: one 20 s piece each
            freqs, amps = rng.uniform(80, 1000, 4), rng.uniform(0.05, 0.25, 4)
            phases = rng.uniform(0, 2 * np.pi, 4)
            song = sum(a * np.sin(2 * np.pi * f * t_song + p)
                       for f, a, p in zip(freqs, amps, phases))
            wavio.write_wav(tmp / "songs" / f"song_{i}.wav", song.astype(np.float32), sr)
        cli.main(["dataset", "build-audio", "--audio-dir", str(tmp / "songs"),
                  "--out-dir", str(tmp / "data"), "--duration", "20"])
        pkl = tmp / "data" / "np_audio.pkl"
        windows = AudioWindows.from_pickle(pkl, full.receptive_field,
                                           shipped["dataset_params"]["window_length"])
        batch_size = shipped["dataset_params"]["batch_size"]
        per_epoch = len(windows) // batch_size

        def params_dir(name, model_file, model_json, family, **train):
            """A params directory: the shipped model, dataset and train
            params, the dataset at ``pkl``, logs and checkpoints in ``tmp``."""
            d = tmp / name
            d.mkdir(exist_ok=True)
            (d / model_file).write_text(json.dumps(model_json))
            (d / "dataset_params.json").write_text(json.dumps(
                {**family["dataset_params"], "audio_path": str(pkl)}))
            (d / "train_params.json").write_text(json.dumps(
                {**family["train_params"], "learning_rate": 1e-3, "print_every": 1,
                 "log_dir": str(tmp / f"{name}_logs"), "restore_dir": str(tmp / f"{name}_ckpt"),
                 **train}))
            return d

        wn_dir = params_dir("wavenet", "wavenet_params.json", shipped["wavenet_params"], shipped,
                            num_epochs=2)
        t0 = time.perf_counter()
        cli.main(["wavenet", "train", "--params-dir", str(wn_dir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logged = [json.loads(line) for line in (tmp / "wavenet_logs" / "metrics.jsonl").open()
                  if '"kind": "loss"' in line]
        if len(logged) != 2 * per_epoch or checkpoint.latest_step(tmp / "wavenet_ckpt") != len(
                logged):
            fail(f"[16] wavenet train: {len(logged)} logged steps, checkpoint at "
                 f"{checkpoint.latest_step(tmp / 'wavenet_ckpt')}, want {2 * per_epoch}")
        losses = [round(r["loss"], 4) for r in logged]
        print(f"[16] wavenet train, shipped width: {len(windows)} windows of "
              f"{windows.window} codes, {len(logged)} steps of {batch_size} in {wall:.2f} s "
              f"(first call: allocator and kernels cold); loss trace {losses}; trainer's "
              f"pieces/s at its last step {logged[-1]['pieces_per_sec']}  [{card}]", flush=True)
        if not all(np.isfinite(losses)):
            fail("[16] wavenet train: a loss is not finite")
        (wn_dir / "train_params.json").write_text(json.dumps(
            {**json.loads((wn_dir / "train_params.json").read_text()), "num_epochs": 1}))
        cli.main(["wavenet", "train", "--params-dir", str(wn_dir)])
        resumed = metrics.MetricsLogger(tmp / "wavenet_logs", echo=False).last_step()
        if resumed != 3 * per_epoch or checkpoint.latest_step(tmp / "wavenet_ckpt") != resumed:
            fail(f"[16] the resumed run ended at step {resumed}, want {3 * per_epoch}")
        print(f"[16] resumed from step {2 * per_epoch} to {resumed}: checkpoints "
              f"{checkpoint.all_steps(tmp / 'wavenet_ckpt')}", flush=True)

        # the trainer's step alone, on one batch, after a warm-up step
        tx = optim.from_config(shipped["train_params"])
        state = checkpoint.restore(tmp / "wavenet_ckpt", wavenet_train.init_state(
            torch.Generator().manual_seed(0), full, tx, dev))
        batch = torch.from_numpy(next(windows.batches(batch_size))).to(dev)
        train_ms = {}
        for label, compute_dtype in (("f32", None), ("compute_dtype bf16", torch.bfloat16)):
            step_fn = wavenet_train.make_train_step(full, tx, compute_dtype)
            st, loss = step_fn(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                st, loss = step_fn(st, batch)
            loss = float(loss)
            torch.cuda.synchronize()
            train_ms[label] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            print(f"[16] trainer step, shipped width, window {windows.window}, batch "
                  f"{batch_size}, {label}: {train_ms[label]:.1f} ms a step = "
                  f"{batch_size / train_ms[label] * 1e3:.1f} pieces/s over {TRAIN_STEPS} steps, "
                  f"loss {loss:.4f}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]", flush=True)
        del st, state, batch

        ae_dir = params_dir("wavenet_ae", "model_params.json", shipped_ae["model_params"],
                            shipped_ae, num_epochs=1)
        t0 = time.perf_counter()
        cli.main(["wavenet-ae", "train", "--params-dir", str(ae_dir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ae_logged = [json.loads(line)
                     for line in (tmp / "wavenet_ae_logs" / "metrics.jsonl").open()
                     if '"kind": "loss"' in line]
        ae_losses = [round(r["loss"], 4) for r in ae_logged]
        if len(ae_logged) != per_epoch or not all(np.isfinite(ae_losses)):
            fail(f"[16] wavenet-ae train: losses {ae_losses}, want {per_epoch} finite")
        print(f"[16] wavenet-ae train, shipped width: {len(ae_logged)} steps of {batch_size} in "
              f"{wall:.2f} s (first call, cold); loss trace {ae_losses}; trainer's pieces/s at "
              f"its last step {ae_logged[-1]['pieces_per_sec']}  [{card}]", flush=True)
        new_phase_s["16"] = time.perf_counter() - t_new

        # -- 17. the trained checkpoint decoded on the card through the CLI (B1,
        # one f32 stream), tie-aware against the plain model
        t0 = time.perf_counter()
        reset_counts()
        cli.main(["wavenet", "generate", "--checkpoint", str(tmp / "wavenet_ckpt"),
                  "--params-dir", str(wn_dir), "--duration", "0.25",
                  "--out", str(tmp / "trained.wav")])
        torch.cuda.synchronize()
        if dec.LAUNCHES != 1 or hbm.LAUNCHES != 0:
            fail("[17] the trained checkpoint was not decoded by one launch of B1")
        main_path_launches["wavenet_decode"] += dec.LAUNCHES
        tp_ = wn.params_from_numpy(checkpoint.restore_subtree(tmp / "wavenet_ckpt", ".params"),
                                   device=dev, cfg=full)
        toks = torch.from_numpy(pcm_codes(tmp / "trained.wav", 256)[None, :512]).to(dev)
        scores = teacher_forced_scores(tp_, silence[:1], toks, full)
        check("[17] trained checkpoint, one f32 stream through B1, first 512 steps", toks,
              lambda t: scores, TOL_F32, kernel="wavenet_decode")
        def decisive(scores):  # the share of steps whose top-2 logit margin exceeds 1e-3
            top2 = scores.topk(2, dim=-1).values
            return float(((top2[..., 0] - top2[..., 1]) > 1e-3).float().mean())

        at_random = teacher_forced_scores(
            fp, silence[:1], torch.from_numpy(codes["one stream"][:, :512]).to(dev), full)
        print(f"[17] top-2 logit margin above 1e-3 on {100 * decisive(scores):.1f}% of the 512 "
              f"steps of the trained checkpoint, {100 * decisive(at_random):.1f}% of those of "
              "the random weights of [4]", flush=True)
        new_phase_s["17"] = time.perf_counter() - t0

        # -- 18. the serving sessions on the trained checkpoints: DecodeSession
        # with 32 bf16 categorical streams (4096 steps a call, streams joining
        # and finishing) and f32 argmax join/leave held tie-aware; then
        # AEDecodeSession with the 32 clips of [7] (f32, 4 joining late)
        t0 = time.perf_counter()
        reset_counts()
        data_codes = [np.asarray(c) for c in windows.data.reshape(2, -1)]
        P_full = full.receptive_field + max(full.dilations)

        def data_prime(i):  # a prime of real codes from the dataset's piece i % 2
            start = (i // 2 + 1) * (len(data_codes[0]) - P_full) // 8
            return data_codes[i % 2][start : start + P_full]

        sess = DecodeSession(full, tp_, capacity=32, seed=5, steps_per_call=SESSION_STEPS)
        for _ in range(28):
            sess.add()
        call_walls = []
        for call in range(3):
            if call == 1:  # four streams join, primed with the dataset's codes
                for j in range(4):
                    sess.add(data_prime(j))
            if call == 2:  # four finish, four more join
                for sid in sess.active[:4]:
                    sess.finish(sid)
                for _ in range(4):
                    sess.add()
            tails = sess.state_dict()
            t1 = time.perf_counter()
            out = sess.step()
            torch.cuda.synchronize()
            call_walls.append(time.perf_counter() - t1)
            if len(out) != len(sess.active) or any(v.shape != (SESSION_STEPS,) for v in out.values()):
                fail(f"[18] DecodeSession call {call}: {len(out)} streams of "
                     f"{[v.shape for v in out.values()][:1]}")
        if dec.LAUNCHES != 3 or hbm.LAUNCHES != 0:
            fail(f"[18] DecodeSession: {dec.LAUNCHES} launches of B1, {hbm.LAUNCHES} of B2")
        session_launches = dec.LAUNCHES
        # the last call's split: prime and packs (prepare), the kernel alone
        # (CUDA events, SESSION_STEPS steps), and the rest (rows, copies, tails)
        rows = np.stack([tails["streams"][s] for s in sorted(tails["streams"])])
        prime_rows = torch.from_numpy(rows).to(dev)
        opts = dict(cfg=full, dtype=bf16, sample_mode="categorical", seed=tails["seed"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inputs = dec.prepare(tp_, prime_rows, n_streams=1, n_stream_groups=32, **opts)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t1
        ker_s = timed(lambda n: dec.decode_cuda(*inputs, n_steps=n, n_streams=1, **opts),
                      SESSION_STEPS, 1) * (SESSION_STEPS - 1) / 1e3
        wall_s = call_walls[-1]
        print(f"[18] DecodeSession, 32 bf16 categorical streams, {SESSION_STEPS} steps a call: "
              "call walls "
              f"{', '.join(f'{w * 1e3:.1f}' for w in call_walls)} ms; last call: prime and "
              f"packs {prep_s * 1e3:.1f} ms + kernel {ker_s * 1e3:.1f} ms + the rest "
              f"{(wall_s - prep_s - ker_s) * 1e3:.1f} ms; overhead {100 * (1 - ker_s / wall_s):.1f}"
              f"% of the call  [{card}]", flush=True)

        reset_counts()
        fsess = DecodeSession(full, tp_, capacity=4, dtype=f32, sample_mode="argmax",
                              steps_per_call=512)
        primes = [data_prime(i + 4) for i in range(4)]
        streams = {}
        sids = [fsess.add(primes[0]), fsess.add(primes[1])]
        for call in range(3):
            if call == 1:
                sids.append(fsess.add(primes[2]))
            if call == 2:
                fsess.finish(sids[0])
                sids.append(fsess.add(primes[3]))
            for sid, codes in fsess.step().items():
                streams.setdefault(sids.index(sid), []).append(codes)
        if dec.LAUNCHES != 3:
            fail(f"[18] f32 DecodeSession: {dec.LAUNCHES} launches of B1, want 3")
        session_launches += dec.LAUNCHES
        for i, chunks in sorted(streams.items()):
            toks = torch.from_numpy(np.concatenate(chunks)[None]).to(dev)
            prime_i = torch.from_numpy(primes[i][None]).to(dev)
            whole = wavenet_generate._fused_decode(tp_, prime_i, full, toks.shape[1], f32,
                                                   "argmax", 1.0, 0)
            for name, t_ in (("session", toks), ("uninterrupted decode", whole)):
                check(f"[18] f32 DecodeSession stream {i} ({len(chunks)} calls), {name}", t_,
                      model_scores(tp_, prime_i, full), TOL_F32, kernel="wavenet_decode")
            print(f"    [18] stream {i}: session and uninterrupted decode equal on "
                  f"{int((whole == toks).sum())}/{toks.numel()} tokens", flush=True)
        main_path_launches["wavenet_decode"] += session_launches

        reset_counts()
        ae_tp = ae.params_from_numpy(checkpoint.restore_subtree(tmp / "wavenet_ae_ckpt",
                                                                ".params"), device=dev, cfg=ae_full)
        src_np = src_codes.cpu().numpy()
        aes = AEDecodeSession(ae_full, ae_tp, capacity=n_clips, steps_per_call=SESSION_STEPS)
        ae_sids = [aes.add(src_np[i]) for i in range(n_clips - 4)]
        ae_out, ae_walls, ae_state = {}, [], []
        for call in range(3):
            if call == 1:
                ae_sids += [aes.add(src_np[i]) for i in range(n_clips - 4, n_clips)]
            ae_state.append(aes.state_dict())
            t1 = time.perf_counter()
            for sid, codes in aes.step().items():
                ae_out.setdefault(sid, []).append(codes)
            torch.cuda.synchronize()
            ae_walls.append(time.perf_counter() - t1)
        if aedec.LAUNCHES != 3 or aehbm.LAUNCHES != 0:
            fail(f"[18] AEDecodeSession: {aedec.LAUNCHES} launches of B3, {aehbm.LAUNCHES} of B4")
        main_path_launches["wavenet_ae_decode"] += aedec.LAUNCHES
        with torch.no_grad(), full_fp32():
            trained_enc = ae.encode(ae_tp, src_codes, ae_full)
        ae_P = ae_full.receptive_field + max(ae_full.dilations)
        for sid, call in ((0, 0), (0, 1), (n_clips - 1, 1), (1, 2)):
            # the call's first 512 codes, teacher-forced from the tail it
            # started from on the stream's absolute clock
            first = call - (1 if sid >= n_clips - 4 else 0)
            st = ae_state[call]["streams"][sid]
            toks = torch.from_numpy(ae_out[sid][first][None, :512]).to(dev)
            tail = torch.from_numpy(st["tail"][None]).to(dev)
            check(f"[18] AEDecodeSession clip {sid}, call {call} (clock {st['clock']}), first "
                  "512 steps", toks,
                  lambda t, sid=sid, tail=tail, clock=st["clock"]: ae_teacher_forced_scores(
                      ae_tp, trained_enc[sid:sid + 1], tail, t, ae_full, pos_offset=clock),
                  TOL_F32, kernel="wavenet_ae_decode")
        # the table build of one call at 32 clips: the session's window of
        # frames, against every stream's whole encoding
        win = torch.stack([aes._window(aes._streams[s]["enc"], aes._streams[s]["clock"])[0]
                           for s in aes.active])
        table_ms = {}
        for label, enc_ in (("window", win), ("whole encoding", trained_enc)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                aedec.build_cond_tables(ae_tp, enc_, ae_full, f32)
            torch.cuda.synchronize()
            table_ms[label] = ((time.perf_counter() - t1) / 5 * 1e3, enc_.shape[1])
        S_ae, G_ae = stream_tiling(n_clips, dev, aedec.max_streams(ae_full))
        pos = torch.tensor([aes._window(aes._streams[s]["enc"], aes._streams[s]["clock"])[1]
                            for s in aes.active], device=dev)
        tails_ae = torch.from_numpy(np.stack([aes._streams[s]["tail"] for s in aes.active]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inputs = aedec.prepare(ae_tp, win, tails_ae.to(dev), cfg=ae_full, n_streams=S_ae,
                               n_stream_groups=G_ae, pos_offset=pos)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t1
        ker_s = timed(lambda n: aedec.decode_cuda(*inputs, cfg=ae_full, n_steps=n,
                                                  n_streams=S_ae), SESSION_STEPS, 1)
        ker_s *= (SESSION_STEPS - 1) / 1e3
        print(f"[18] AEDecodeSession, 32 f32 clips, {SESSION_STEPS} steps a call: call walls "
              f"{', '.join(f'{w * 1e3:.1f}' for w in ae_walls)} ms; a call's prime, packs and "
              f"tables {prep_s * 1e3:.1f} ms + kernel {ker_s * 1e3:.1f} ms; overhead "
              f"{100 * (1 - ker_s / ae_walls[-1]):.1f}% of the last call; table build "
              + ", ".join(f"{k} ({f} frames) {ms:.2f} ms" for k, (ms, f) in table_ms.items())
              + f"  [{card}]", flush=True)
        new_phase_s["18"] = time.perf_counter() - t0
    print(f"[18] the train and serve phases 16-18 took {time.perf_counter() - t_new:.1f} s ("
          + ", ".join(f"{k}: {v:.1f} s" for k, v in new_phase_s.items()) + ")", flush=True)

    # -- 19-20. SeqGAN and LeakGAN at the shipped widths (no decode kernel
    # lies on their paths: the counts of the kernels line stay as 4-18 left them)
    reset_counts()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp, full_fp32():
        gan_phases(card, dev, Path(tmp))
    if dec.LAUNCHES or aedec.LAUNCHES or hbm.LAUNCHES or aehbm.LAUNCHES:
        fail("[20] the GAN phases launched a decode kernel")
    if "jax" in sys.modules or any(m == "music_tpu" or m.startswith("music_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported")

    # -- 21. the kernels line (ms per decode step of one f32 stream: B1 and
    # B3 at the shipped width, B2 and B4 at the scaled width; no single
    # PyTorch call computes any of the decodes; the GAN phases 19-20 launch
    # none of them)
    described = [
        ("wavenet_decode", "music_tpu/kernels/wavenet_decode.py:134", b1),
        ("wavenet_ae_decode", "music_tpu/kernels/wavenet_ae_decode.py:324", b3),
        ("wavenet_decode_hbm", "music_tpu/kernels/wavenet_decode_hbm.py:207", b2),
        ("wavenet_ae_decode_hbm", "music_tpu/kernels/wavenet_ae_decode_hbm.py:136", b4),
    ]
    print(f"[21] the whole run took {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"music_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": main_path_launches[name],
        "max_abs_err": worst_deficit[name],
        "ms": m["times"][0],
        "plain_ms": m["times"][1],
        "bound_ms": m["bound"][0],
        "bound_by": m["bound"][1],
        "library_ms": None,
    } for name, replaces, m in described]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
