"""Fused WaveNet autoregressive decode: one CUDA launch for the whole loop.

Counterpart of :mod:`music_tpu.kernels.wavenet_decode` (the Pallas kernel
``_decode_kernel`` and its wrapper ``generate_tokens_fused``).  The kernel
is ``csrc/wavenet_decode.cu``; :func:`decode_reference` is its plain
PyTorch version, with the same weight packs, ring layout, bf16 rounding
points and Philox draws.

Layout on the card (no TPU lane tricks: tokens are indices, embeddings are
row gathers):

- **Rings**: ``[B, sum(d_i), Cr]`` in the working dtype; layer ``i`` owns
  rows ``off_i .. off_i + d_i`` and at step ``t`` reads, then overwrites,
  row ``off_i + t mod d_i``.
- **Weights**: ``ecur``/``eprev`` ``[Q, Cr]`` (the causal taps on the
  current / previous token), ``fg [L, 2*Cr, 2*Cd]`` (rows ``0..Cr`` the
  ring tap, ``Cr..2Cr`` the current input), ``dense [L, Cd, Cr]``,
  ``skip [L*Cd, Cs]``, ``post1 [Cs, Cs]``, ``post2 [Cs, Q]``.
- **Streams**: the grid has ``n_stream_groups`` blocks of ``n_streams``
  streams each; rows are padded to ``n_streams * n_stream_groups``.
- **Output**: ``[B, n_steps]`` int32 ``[s_0, s_1, ...]``; ``s_0`` is drawn
  on the host from the prime, the kernel draws the rest.

Categorical mode draws Gumbel-max with Philox4x32-10 (``ops/philox.py``):
token ``k`` of stream row ``r`` uses key ``(seed, r)`` and counter
``(lane block, k)``, on the card and in the plain version alike.
"""

from __future__ import annotations

import ctypes

import torch

from music_tpu_torch.kernels import _build
from music_tpu_torch.models.wavenet import WaveNetConfig, _gate, forward
from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, full_fp32, token_causal_conv
from music_tpu_torch.ops.philox import decode_uniforms, gumbel

SUPPORTED_STREAMS = (1, 2, 4, 8, 16)
"""Streams per thread block the kernel is compiled for."""
SMEM_LIMIT = 232_448
"""Shared memory one block can have on an H100 (227 KB)."""
MAX_STAGES = 4
"""Most layer stages the kernel rings (``kMaxStages`` in
``csrc/decode_resident.cuh``); it needs at least 2."""

LAUNCHES = 0
"""Kernel launches so far in this process (the CUDA wrapper adds one per
launch; the CPU path never does)."""

_SAMPLE_MODES = {"argmax": 0, "categorical": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ring_offsets(cfg: WaveNetConfig) -> tuple[list[int], int]:
    """First ring row of every layer, and the ring length ``sum(d_i)``."""
    offs, o = [], 0
    for d in cfg.dilations:
        offs.append(o)
        o += d
    return offs, o


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def smem_layout(L: int, Cr: int, Cd: int, Cs: int, Q: int, S: int, dtype: torch.dtype,
                ae: bool = False, layer_skip: bool = False) -> tuple[list[int], int]:
    """The resident kernels' shared-memory carve for ``S`` streams per
    block: ``(offsets, bytes)``, as ``csrc/decode_resident.cuh`` reads
    them: the offsets in floats of ``zall, h1, h2, ptap`` and the stages
    (``x`` is at 0), the stage stride in floats, the stage count, and the
    offset of the ints.

    Per stream x ``[Cr]``, zall ``[L*Cd]`` (with ``layer_skip``, the
    weight-streaming kernels' per-layer skip, two layers' z ``[2, Cd]``),
    h1 ``[Cs]`` (skip_acc before it with ``layer_skip``, the logits
    ``[Q]`` after it), h2 ``[Cs]`` and two layers' tap halves of fg ``[2,
    2Cd]`` in float32; then as many stages as fit, 2 to :data:`MAX_STAGES`, each one
    layer's chain operands in ``dtype``: its rows of :func:`chain_packs`
    (fg ``[2Cd, 2Cr + pad]``, dense ``[Cr, Cd + pad]``), every stream's tap
    ``[Cr]`` and, for the autoencoder (``ae``), its conditioning row
    ``[2Cd]``; then ``cur, prev, clock`` per stream and ``dil, off, slot``
    per layer.  When 2 stages do not fit, ``bytes`` exceeds
    :data:`SMEM_LIMIT`."""
    esize = torch.tensor([], dtype=dtype).element_size()
    pad = 16 // esize
    elems = 2 * Cd * (2 * Cr + pad) + Cr * (Cd + pad) + S * Cr + (2 * S * Cd if ae else 0)
    stage = _pad4(-(-esize * elems // 4))
    sizes = [S * Cr, S * (2 if layer_skip else L) * Cd, S * max(Cs, Q), S * Cs,
             2 * S * 2 * Cd]  # x .. ptap
    offsets, o = [], 0
    for n in sizes:
        offsets.append(o)
        o += _pad4(n)
    ints = 4 * (3 * S + 3 * L)
    n_stages = 2
    while n_stages < MAX_STAGES and 4 * (o + (n_stages + 1) * stage) + ints <= SMEM_LIMIT:
        n_stages += 1
    end = o + n_stages * stage
    return offsets[1:] + [o, stage, n_stages, end], 4 * end + ints


def fits(layout: tuple[list[int], int], min_stages: int = 2) -> bool:
    """Whether a carve of :func:`smem_layout` fits :data:`SMEM_LIMIT` with at
    least ``min_stages`` stages (3 give the kernel its helper warp)."""
    offsets, nbytes = layout
    return nbytes <= SMEM_LIMIT and offsets[6] >= min_stages


def max_streams(cfg: WaveNetConfig, dtype: torch.dtype = torch.float32,
                min_stages: int = 2) -> int:
    """The most streams per block (of :data:`SUPPORTED_STREAMS`) whose
    carve fits :data:`SMEM_LIMIT` in ``dtype`` with at least ``min_stages``
    stages; 0 when none does."""
    dims = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
            cfg.quantization_channels)
    return max((s for s in SUPPORTED_STREAMS if fits(smem_layout(*dims, s, dtype), min_stages)),
               default=0)


def chain_packs(fg: torch.Tensor, dense: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer chain's weights as the kernel stages them: ``fg [L, 2Cr,
    2Cd]`` and ``dense [L, Cd, Cr]`` transposed to one row per output
    column, each row padded by 16 bytes (``[L, 2Cd, 2Cr + pad]``, ``[L, Cr,
    Cd + pad]``), so that a chain lane reads its columns with 16-byte loads
    that fall in distinct shared-memory banks."""
    pad = 16 // fg.element_size()
    return tuple(torch.nn.functional.pad(t.transpose(1, 2), (0, pad)).contiguous()
                 for t in (fg, dense))


def check_tile(dims: tuple, n_streams: int, dtype: torch.dtype, ae: bool = False,
               layer_skip: bool = False):
    """The carve of a tile of ``n_streams`` (``dims = (L, Cr, Cd, Cs, Q)``),
    refused before any launch when it exceeds :data:`SMEM_LIMIT` or when the
    widths break the kernel's 16-byte copies and loads.  Returns ``(offsets,
    bytes)``."""
    L, Cr, Cd, Cs, Q = dims
    offsets, nbytes = smem_layout(*dims, n_streams, dtype, ae, layer_skip)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{n_streams} streams per block need {nbytes} bytes of shared memory "
                         f"(limit {SMEM_LIMIT}); take at most max_streams()")
    if Cr % 8 or Cd % 8 or Cs % 8 or Q % 8:
        raise ValueError(f"the kernel needs Cr, Cd, Cs and Q multiples of 8, got "
                         f"Cr={Cr}, Cd={Cd}, Cs={Cs}, Q={Q}")
    return offsets, nbytes


def _check_supported(cfg: WaveNetConfig) -> None:
    if cfg.filter_width != 2:
        raise NotImplementedError("fused decode assumes filter_width=2")
    if cfg.use_bias:
        # the decode has no bias terms; dropping them silently would change
        # the model, so biased models are refused
        raise NotImplementedError("fused decode does not support use_bias=True")
    if cfg.quantization_channels % 4:
        raise NotImplementedError("fused decode needs quantization_channels % 4 == 0")


def _build_kernel_weights(params: dict, cfg: WaveNetConfig, dtype: torch.dtype) -> dict:
    """Repack the model parameters into the kernel's layouts (contiguous,
    in the working dtype)."""
    L, Cr, Cd, Cs = (
        cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
    )
    w = {
        "ecur": params["causal"][1],
        "eprev": params["causal"][0],
        "fg": params["fg"].reshape(L, 2 * Cr, 2 * Cd),
        "dense": params["dense"],
        "skip": params["skip"].reshape(L * Cd, Cs),
        "post1": params["post1"],
        "post2": params["post2"],
    }
    return {k: v.to(dtype).contiguous() for k, v in w.items()}


def _sample_scores(logits, rows, step, sample_mode, temperature, seed, q):
    if sample_mode == "argmax":
        return logits
    return logits / temperature + gumbel(decode_uniforms(seed, rows, step, q))


@torch.no_grad()
def _collect_prime_state(
    params: dict, prime: torch.Tensor, cfg: WaveNetConfig,
    sample_mode: str = "argmax", temperature: float = 1.0, seed: int = 0,
):
    """Parallel prime: a conv forward over the prime fills the rings and
    draws the first token.

    Returns ``(ring [B, sum(d), Cr] float32, s0 [B] int32, prev0 [B] int32)``.
    Entering kernel step 0, row ``s`` of layer ``i``'s ring holds its input
    at absolute time ``P - d_i + s`` (P = prime length), so step ``t``
    reads time ``P + t - d_i``.  Needs ``P >= receptive_field + max(d)``.
    """
    P = prime.shape[1]
    need = cfg.receptive_field + max(cfg.dilations)
    if P < need:
        raise ValueError(f"prime length {P} < receptive_field + max_dilation = {need}")
    offs, ring_len = ring_offsets(cfg)
    B = prime.shape[0]
    p32 = {k: v.float() for k, v in params.items()}
    ring = torch.empty(
        (B, ring_len, cfg.residual_channels), dtype=torch.float32, device=prime.device
    )
    with full_fp32():
        x = token_causal_conv(prime, p32["causal"])  # absolute offset 1
        o = 1
        for i, d in enumerate(cfg.dilations):
            ring[:, offs[i] : offs[i] + d] = x[:, P - d - o : P - o]
            fg = dilated_causal_conv(x, p32["fg"][i], dilation=d)
            x = conv1x1(_gate(fg), p32["dense"][i]) + x[:, -fg.shape[1]:]
            o += d
        logits = forward(p32, prime[:, -cfg.receptive_field:], cfg)[:, -1]
    rows = torch.arange(B, device=prime.device)
    scores = _sample_scores(
        logits, rows, 0, sample_mode, temperature, seed, cfg.quantization_channels
    )
    s0 = torch.argmax(scores, dim=-1).to(torch.int32)
    return ring, s0, prime[:, -1].to(torch.int32)


def prepare(
    params: dict, prime: torch.Tensor, *, cfg: WaveNetConfig, n_streams: int,
    n_stream_groups: int = 1, dtype: torch.dtype = torch.float32,
    sample_mode: str = "argmax", temperature: float = 1.0, seed: int = 0,
):
    """Pad the prime rows to ``n_streams * n_stream_groups`` and build the
    kernel inputs ``(weights, ring, s0, prev0)``."""
    _check_supported(cfg)
    if sample_mode not in _SAMPLE_MODES:
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    B, total = prime.shape[0], n_streams * n_stream_groups
    if B > total:
        raise ValueError(f"at most {total} streams, got {B}")
    if B < total:
        prime = torch.cat([prime, prime[-1:].expand(total - B, -1)], dim=0)
    ring, s0, prev0 = _collect_prime_state(
        params, prime, cfg, sample_mode=sample_mode, temperature=temperature, seed=seed
    )
    return _build_kernel_weights(params, cfg, dtype), ring, s0, prev0


@torch.no_grad()
def decode_reference(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor, *,
    cfg: WaveNetConfig, n_steps: int, dtype: torch.dtype = torch.float32,
    sample_mode: str = "argmax", temperature: float = 1.0, seed: int = 0,
    forced: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel, on any device.

    Products accumulate in float32; with ``dtype=bfloat16`` the weights and
    rings hold bf16 and activations are rounded to bf16 where the TPU
    kernel rounds them: after the embedding sum, z, the residual add, and h
    after each relu.  Logits stay float32.  Returns ``[B, n_steps]`` int32.

    With ``forced`` (``[B, n_steps]`` tokens, e.g. the kernel's output) the
    loop feeds those tokens instead of its own draws (teacher forcing) and
    returns the float32 logits ``[B, n_steps - 1, Q]`` it gave tokens
    ``1 .. n_steps - 1``.
    """
    Cd, Q = cfg.dilation_channels, cfg.quantization_channels
    if dtype == torch.bfloat16:
        def rnd(v):
            return v.to(torch.bfloat16).float()
    else:
        def rnd(v):
            return v
    offs, _ = ring_offsets(cfg)
    B = ring.shape[0]
    ring = ring.to(dtype=dtype, copy=True)
    wf = {k: v.float() for k, v in w.items()}
    out = torch.empty((B, n_steps), dtype=torch.int32, device=ring.device)
    out[:, 0] = s0
    if forced is not None:
        forced = forced.to(ring.device, torch.long)
        if tuple(forced.shape) != (B, n_steps) or n_steps < 2:
            raise ValueError(f"forced tokens {tuple(forced.shape)}: need {(B, n_steps)}, "
                             "n_steps >= 2")
        s0 = forced[:, 0]
    all_logits = []
    cur, prev = s0.long(), prev0.long()
    rows = torch.arange(B, device=ring.device)
    with full_fp32():
        for t in range(n_steps - 1):
            x = rnd(wf["ecur"][cur] + wf["eprev"][prev])
            zs = []
            for i, d in enumerate(cfg.dilations):
                slot = offs[i] + t % d
                fg = torch.cat([ring[:, slot].float(), x], dim=-1) @ wf["fg"][i]
                ring[:, slot] = x.to(dtype)  # after the read of the same slot
                z = rnd(torch.tanh(fg[:, :Cd]) * torch.sigmoid(fg[:, Cd:]))
                x = rnd(x + z @ wf["dense"][i])
                zs.append(z)
            h = rnd(torch.relu(torch.cat(zs, dim=-1) @ wf["skip"]))
            h = rnd(torch.relu(h @ wf["post1"]))
            logits = h @ wf["post2"]
            if forced is None:
                scores = _sample_scores(logits, rows, t + 1, sample_mode, temperature, seed, Q)
                nxt = torch.argmax(scores, dim=-1)
                out[:, t + 1] = nxt.to(torch.int32)
            else:
                all_logits.append(logits)
                nxt = forced[:, t + 1]
            prev, cur = cur, nxt
    if forced is not None:
        return torch.stack(all_logits, dim=1)
    return out


ARGTYPES = (
    [ctypes.c_int] * 3                      # dtype, S, G
    + [ctypes.c_void_p] * 2                 # dims [8], carve offsets [8] (host int32 arrays)
    + [ctypes.c_int, ctypes.c_void_p]       # smem bytes, device pointers [16] (POINTERS)
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint32]  # n_steps, mode, temp, seed
    + [ctypes.c_void_p]                     # stream
)
"""ctypes argument types of the C entry ``wavenet_decode``."""
POINTERS = ("dil", "ring", "s0", "prev0", "pos0", "ecur", "eprev", "fg", "dense", "skip",
            "post1", "post2", "cond_fg", "cond_post", "out", "spans")
"""The device pointers of a launch, in the order of ``ResPtr`` in
``csrc/decode_resident.cuh``."""
SPAN_PHASES = ("embedding and first stage", "layer wait and barrier", "layer copies issued",
               "fg and gate", "dense and residual", "skip", "post", "sampling", "total")
"""What each cycle count of a phase-timed launch sums (``kSpans`` in
``csrc/decode_resident.cuh``); the layer phases are the chain warp's."""


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_decode")
    lib.wavenet_decode.argtypes = ARGTYPES
    lib.wavenet_decode.restype = ctypes.c_int
    lib.wavenet_decode_error.argtypes = [ctypes.c_int]
    lib.wavenet_decode_error.restype = ctypes.c_char_p
    return lib


def launch_args(dims: list[int], offsets: list[int], ptrs: dict):
    """The host arrays of one launch: ``dims`` and the carve ``offsets`` as
    int32, and the device pointers named in :data:`POINTERS` (absent ones
    null).  The caller keeps them alive across the call."""
    dims_a = (ctypes.c_int * len(dims))(*dims)
    offs_a = (ctypes.c_int * len(offsets))(*offsets)
    ptrs_a = (ctypes.c_void_p * len(POINTERS))(
        *[ptrs[k].data_ptr() if k in ptrs else None for k in POINTERS])
    return dims_a, offs_a, ptrs_a


def check_aligned(tensors: dict) -> None:
    """The kernel copies and loads 16 bytes at a time: every base address
    must be 16-byte aligned."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def decode_cuda(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor, *,
    cfg: WaveNetConfig, n_steps: int, n_streams: int,
    dtype: torch.dtype = torch.float32, sample_mode: str = "argmax",
    temperature: float = 1.0, seed: int = 0, spans: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (same arguments and
    result as :func:`decode_reference`).  Raises on anything it does not
    take, a tile larger than :func:`max_streams` included, and when the
    launch is refused.  ``spans``, an int64 CUDA tensor with one entry per
    :data:`SPAN_PHASES`, runs the
    phase-timed build instead (float32, one stream a block), which writes
    block 0's cycle counts per phase (:data:`SPAN_PHASES`) into it."""
    global LAUNCHES
    _check_supported(cfg)
    L, Cr, Cd, Cs, Q = (
        cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels,
        cfg.skip_channels, cfg.quantization_channels,
    )
    _, ring_len = ring_offsets(cfg)
    B = ring.shape[0]
    if n_streams not in SUPPORTED_STREAMS or B % n_streams:
        raise ValueError(f"{B} rows do not split into blocks of n_streams={n_streams} "
                         f"(supported: {SUPPORTED_STREAMS})")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    offsets, nbytes = check_tile((L, Cr, Cd, Cs, Q), n_streams, dtype)
    if sample_mode not in _SAMPLE_MODES:
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    shapes = {
        "ecur": (Q, Cr), "eprev": (Q, Cr), "fg": (L, 2 * Cr, 2 * Cd), "dense": (L, Cd, Cr),
        "skip": (L * Cd, Cs), "post1": (Cs, Cs), "post2": (Cs, Q),
    }
    device = ring.device
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs CUDA tensors, got {device}")
    for k, shape in shapes.items():
        t = w[k]
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"weight {k}: need contiguous {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(ring.shape) != (B, ring_len, Cr):
        raise ValueError(f"ring shape {tuple(ring.shape)} != {(B, ring_len, Cr)}")
    for name, t in (("s0", s0), ("prev0", prev0)):
        if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: need int32 [{B}] on {device}")
    if spans is not None and (spans.device != device or spans.dtype != torch.int64
                              or tuple(spans.shape) != (len(SPAN_PHASES),)
                              or dtype != torch.float32 or n_streams != 1):
        raise ValueError(f"spans: need int64 [{len(SPAN_PHASES)}] on the decode's device, "
                         "float32, n_streams=1")
    ring = ring.to(dtype=dtype, copy=True).contiguous()  # the kernel updates it in place
    ptrs = {k: w[k] for k in shapes}
    ptrs["fg"], ptrs["dense"] = chain_packs(w["fg"], w["dense"])
    check_aligned({**ptrs, "ring": ring})
    ptrs.update(ring=ring, s0=s0.contiguous(), prev0=prev0.contiguous(),
                dil=torch.tensor(cfg.dilations, dtype=torch.int32, device=device),
                out=torch.empty((B, n_steps), dtype=torch.int32, device=device))
    if spans is not None:
        ptrs["spans"] = spans
    dims_a, offs_a, ptrs_a = launch_args([L, Cr, Cd, Cs, Q, ring_len, 1, 1], offsets, ptrs)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wavenet_decode(
            _DTYPES[dtype], n_streams, B // n_streams, dims_a, offs_a, nbytes, ptrs_a,
            n_steps, _SAMPLE_MODES[sample_mode], float(temperature), seed & 0xFFFFFFFF, stream,
        )
    if rc != 0:
        raise RuntimeError(f"wavenet_decode launch failed: {lib.wavenet_decode_error(rc).decode()}")
    LAUNCHES += 1
    return ptrs["out"]


def generate_tokens_fused(
    params: dict,
    prime: torch.Tensor,
    *,
    cfg: WaveNetConfig,
    n_steps: int,
    n_streams: int,
    n_stream_groups: int = 1,
    dtype: torch.dtype = torch.float32,
    sample_mode: str = "argmax",
    temperature: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """Generate ``n_steps`` codes per stream after priming with ``prime``
    ``[B, P]`` (``B <= n_streams * n_stream_groups``, ``P >=
    receptive_field + max dilation``).  Returns ``[B, n_steps]`` int32.

    Runs the CUDA kernel when ``prime`` lies on a CUDA device and its
    plain version (:func:`decode_reference`) when it lies on the CPU."""
    B = prime.shape[0]
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype, sample_mode=sample_mode,
              temperature=temperature, seed=seed)
    w, ring, s0, prev0 = prepare(
        params, prime, cfg=cfg, n_streams=n_streams, n_stream_groups=n_stream_groups,
        dtype=dtype, sample_mode=sample_mode, temperature=temperature, seed=seed,
    )
    if prime.device.type == "cuda":
        out = decode_cuda(w, ring, s0, prev0, n_streams=n_streams, **kw)
    elif prime.device.type == "cpu":
        out = decode_reference(w, ring, s0, prev0, **kw)
    else:
        raise ValueError(f"unsupported device {prime.device}")
    return out[:B]
