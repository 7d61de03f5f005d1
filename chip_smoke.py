#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (music_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA decode kernel from ``music_tpu_torch/csrc/`` (nvcc);
3. the kernel against its plain PyTorch version on the card at a tiny
   config: f32 argmax with 1 and 11 streams, bf16 with 16 streams,
   categorical (both sides draw the same Philox numbers); exact token
   matches, plus a tie-aware check against the plain model teacher-forced;
4. the main path at the shipped width (40 blocks, Cs=512, Q=256) through
   the CLI on a checkpoint of seeded random weights: one stream (argmax,
   f32) and 32 streams (categorical, bf16), 0.25 s each; launch counts,
   wav lengths and codes checked, and a tie-aware check of the first 512
   steps against the plain model on the card;
5. samples/s of the kernel (2048 steps) and of its plain version (256
   steps) at the main path's shapes, timed with CUDA events;
6. a JSON line describing each kernel, then the device JSON as the last line.

It imports nothing of JAX.  Float32 matmuls in the plain versions run in
full float32 (TF32 off, see ``music_tpu_torch.ops.conv.full_fp32``).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_F32 = 1e-4   # logits are O(0.1); kernel and plain differ in summation order only
# bf16 plain vs the f32 model: max logit error measured 4.5e-4 at the
# shipped width and 3.5e-4 at the tiny config (H100); a token's deficit is
# at most twice the logit error, so 2e-3 leaves a factor 2.2 over that bound
TOL_BF16 = 2e-3
TIMED_STEPS, PLAIN_STEPS = 2048, 256


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


def main() -> None:
    if not (ROOT / "music_tpu_torch").is_dir() or not (ROOT / "music_tpu").is_dir():
        fail(f"run from the root of a checkout (no music_tpu_torch/ beside {__file__})")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from music_tpu_torch import cli
    from music_tpu_torch.core import checkpoint
    from music_tpu_torch.generate.wavenet_generate import stream_tiling
    from music_tpu_torch.kernels import _build
    from music_tpu_torch.kernels import wavenet_decode as dec
    from music_tpu_torch.models import wavenet as wn
    from music_tpu_torch.utils.parity import (
        reference_scores, teacher_forced_scores, tie_aware_check,
    )

    dev = torch.device("cuda")
    # -- 1. identity
    card = card_identity()
    print(card)  # name and power limit, as nvidia-smi gives them
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build
    t0 = time.perf_counter()
    dec._library()
    lib_path = _build.library_path("wavenet_decode")
    built = _build.BUILD_SECONDS.get("wavenet_decode")
    print(f"[2] built {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"({'nvcc ran' if built is not None else 'reused an existing build'})")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print("[2] ptxas:", line.strip())
    sys.stdout.flush()

    worst_deficit = 0.0  # vs the plain version at the kernel's own precision

    def check(name, tokens, scores_fn, tol, *, same_precision=True):
        nonlocal worst_deficit
        report = tie_aware_check(tokens, scores_fn, tol)
        if same_precision:
            worst_deficit = max(worst_deficit, -report["min_margin"])
        print(f"    {name}: tie-aware {report}", flush=True)
        if not report["ok"]:
            fail(f"{name}: a token scores {-report['min_margin']:.3g} below the plain "
                 f"maximum (tolerance {tol})")

    def model_scores(params, prime, cfg, **sampling):
        """The f32 model's teacher-forced scores (+ the decode's Philox noise)."""
        return lambda t: teacher_forced_scores(params, prime, t.to(dev), cfg, **sampling)

    def bf16_logit_error(name, cfg, params, prime, inputs, tokens):
        """Largest |bf16 plain logit - f32 model logit| along ``tokens``; a
        token's tie-aware deficit against the f32 model is at most twice it."""
        plain = reference_scores(inputs, tokens, cfg, dtype=torch.bfloat16)
        err = float((plain - teacher_forced_scores(params, prime, tokens, cfg)[:, 1:]).abs().max())
        print(f"    {name}: bf16 plain vs f32 model, max logit error {err:.3g}", flush=True)
        if 2 * err > TOL_BF16:
            fail(f"{name}: bf16 logit error {err:.3g} exceeds TOL_BF16 / 2")

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
            check(label, ker[:rows], model_scores(params, prime, tiny, **sampling), TOL_F32)
        else:
            check(f"{label} vs the f32 model", ker, model_scores(params, prime, tiny, **sampling),
                  TOL_BF16, same_precision=False)
            bf16_logit_error(label, tiny, params, prime, inputs, ker)

    # -- 4. the main path at the shipped width, through the CLI
    cfg_json = json.loads((ROOT / "music_tpu/params/wavenet/wavenet_params.json").read_text())
    full = wn.WaveNetConfig.from_json(cfg_json)
    full_params = wn.init_params(full, torch.Generator().manual_seed(0))
    n_params = sum(v.numel() for v in full_params.values())
    print(f"[4] shipped config: {full.n_blocks} blocks, Cr={full.residual_channels}, "
          f"Cs={full.skip_channels}, Q={full.quantization_channels}, "
          f"receptive field {full.receptive_field}, {n_params} params")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        checkpoint.save(tmp / "ckpt", 1, TrainState(params=full_params, step=1))
        n_samples = int(0.25 * 16000)
        runs = [
            ("one stream", ["--out", str(tmp / "one.wav")], [tmp / "one.wav"]),
            ("32 streams", ["--out", str(tmp / "many.wav"), "--num", "32",
                            "--sample-mode", "categorical"],
             [tmp / "many" / f"gen_{i:03d}.wav" for i in range(32)]),
        ]
        dec.LAUNCHES = 0
        codes, walls = {}, {}
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
        main_path_launches = dec.LAUNCHES
        if "jax" in sys.modules:
            fail("jax was imported")
    fp = {k: v.to(dev) for k, v in full_params.items()}
    silence = torch.full((32, full.receptive_field + max(full.dilations)),
                         full.quantization_channels // 2, dtype=torch.int32, device=dev)
    one = torch.from_numpy(codes["one stream"][:, :512]).to(dev)
    check("CLI one stream f32, first 512 steps", one, model_scores(fp, silence[:1], full),
          TOL_F32)
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
                                                  sample_mode="categorical"), TOL_F32)
    check("CLI 32 streams bf16 categorical vs the f32 model, first 512 steps", many,
          model_scores(fp, silence, full, sample_mode="categorical"), TOL_BF16,
          same_precision=False)
    bf16_logit_error("CLI 32 streams", full, fp, silence, inputs, many)

    # -- 5. times at the main path's shapes
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

    shapes = [  # (label, CLI run, rows, dtype, mode, streams per block)
        ("1 stream f32 argmax", "one stream", 1, torch.float32, "argmax", 1),
        ("32 streams bf16 categorical", "32 streams", 32, torch.bfloat16, "categorical", s32),
        ("32 streams bf16 categorical, 16 per block", None, 32, torch.bfloat16,
         "categorical", 16),
    ]
    times = {}
    for label, run, rows, dtype, mode, S in shapes:
        inputs = dec.prepare(fp, silence[:rows], cfg=full, n_streams=S,
                             n_stream_groups=-(-rows // S), dtype=dtype, sample_mode=mode)
        kw = dict(cfg=full, dtype=dtype, sample_mode=mode)
        ker = timed(lambda n: dec.decode_cuda(*inputs, n_steps=n, n_streams=S, **kw),
                    TIMED_STEPS, 3)
        plain = timed(lambda n: dec.decode_reference(*inputs, n_steps=n, **kw), PLAIN_STEPS, 1)
        times[label] = (ker, plain)
        print(f"[5] {label} ({S} per block, {-(-rows // S)} blocks): kernel "
              f"{ker * 1e3:.1f} us/step = {rows / ker * 1e3:.0f} samples/s; plain "
              f"{plain * 1e3:.1f} us/step = {rows / plain * 1e3:.0f} samples/s  [{card}]",
              flush=True)
        if run is not None:
            kernel_s = ker * (n_samples - 1) / 1e3
            print(f"[5] CLI {run}: kernel {kernel_s:.3f} s of {walls[run]:.3f} s wall "
                  f"({100 * kernel_s / walls[run]:.0f}%, cold call, timing above)", flush=True)

    ker_ms, plain_ms = times["1 stream f32 argmax"]
    print(json.dumps({"kernels": [{
        "name": "wavenet_decode",
        "route": "cuda",
        "source": "music_tpu_torch/csrc/wavenet_decode.cu",
        "replaces": "music_tpu/kernels/wavenet_decode.py:134",
        "launches": main_path_launches,
        "max_abs_err": worst_deficit,
        "ms": ker_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
