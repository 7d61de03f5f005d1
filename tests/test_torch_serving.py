"""The port's serving sessions (music_tpu_torch.generate.serving) on the
CPU, where the fused backend runs the decode kernels' plain versions:
streams that join, leave and finish over several calls decode what an
uninterrupted decode and the JAX package's sessions decode (tie-aware),
admission control, and state that a new session continues exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.generate.serving import DecodeSession as JDecodeSession
from music_tpu.models import wavenet as jwn
from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.generate import wavenet_ae_generate as aegen
from music_tpu_torch.generate import wavenet_generate as wngen
from music_tpu_torch.generate.serving import AEDecodeSession, DecodeSession
from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_decode
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.mulaw import mu_law_encode
from music_tpu_torch.utils.parity import (
    ae_teacher_forced_scores, teacher_forced_scores, tie_aware_check,
)
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4  # f32 logits O(0.1): candidates may differ from the argmax by summation order only

TINY = wn.WaveNetConfig(dilations=(1, 2, 4, 8, 1, 2, 4, 8), dilation_channels=8,
                        residual_channels=8, skip_channels=16, quantization_channels=32)
AE_TINY = ae.WaveNetAEConfig(
    dilations=(1, 2, 4, 8, 1, 2, 4, 8), en_residual_channel=8, en_dilation_channel=8,
    de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16, en_bottleneck_width=12,
    en_pool_kernel_size=16, quantization_channel=32)
K = 40  # steps a call


def _params(cfg, seed, module=wn):
    return module.init_params(cfg, torch.Generator().manual_seed(seed))


def _jax_params(params):
    return {k: jnp.asarray(v.numpy()) for k, v in params.items()}


def _margin(scores, tokens):
    """The smallest gap between the best and second-best score along
    ``tokens``' steps: above TOL, no summation order can flip a token."""
    top2 = torch.topk(torch.as_tensor(scores), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def _churn(session, primes):
    """Three calls: streams 0 and 1, then 2 joins, then 0 finishes and 3
    joins.  Returns ``{stream: its codes}`` and the calls it took part in."""
    out = {}
    sids = [session.add(primes[0]), session.add(primes[1])]
    for call in range(3):
        if call == 1:
            sids.append(session.add(primes[2]))
        if call == 2:
            session.finish(sids[0])
            sids.append(session.add(primes[3]))
        for sid, codes in session.step().items():
            out.setdefault(sids.index(sid), []).append(np.asarray(codes))
    return {i: np.concatenate(c) for i, c in out.items()}


def test_decode_session_matches_uninterrupted_and_jax():
    """Join, leave and finish over three calls: each stream's codes pass the
    tie-aware check, and so do an uninterrupted generate_batch of the same
    length and JAX's DecodeSession(backend="scan") with the same churn; where
    no step of a stream is near a tie, all three are equal."""
    params = _params(TINY, 0)
    rng = np.random.default_rng(0)
    P = TINY.receptive_field + max(TINY.dilations)
    primes = [rng.integers(0, 32, P + 5).astype(np.int32) for _ in range(4)]
    kw = dict(capacity=3, sample_mode="argmax", steps_per_call=K)
    ours = _churn(DecodeSession(TINY, params, dtype=torch.float32, device="cpu", **kw), primes)
    jcfg = jwn.WaveNetConfig(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    theirs = _churn(JDecodeSession(jcfg, _jax_params(params), dtype=jnp.float32,
                                   backend="scan", **kw), primes)
    assert {i: len(c) for i, c in ours.items()} == {0: 2 * K, 1: 3 * K, 2: 2 * K, 3: K}
    for i, codes in ours.items():
        prime = torch.from_numpy(primes[i][-P:])[None]
        whole = wngen.generate_batch(cfg=TINY, params=params, n=1, start_pieces=prime.numpy(),
                                     duration=len(codes) / 16000, sample_mode="argmax",
                                     dtype=torch.float32, device="cpu")
        whole = mu_law_encode(torch.from_numpy(whole), 32).numpy()[0]

        def scores(t, prime=prime):
            return teacher_forced_scores(params, prime, torch.as_tensor(np.array(t)), TINY)

        for name, toks in (("session", codes), ("uninterrupted", whole),
                           ("JAX session", theirs[i])):
            report = tie_aware_check(toks[None], scores, TOL)
            assert report["ok"], (i, name, report)
        if _margin(scores(codes[None]), codes) > TOL:
            np.testing.assert_array_equal(whole, codes)
            np.testing.assert_array_equal(theirs[i], codes)


def test_decode_session_admission_and_refusals():
    params = _params(TINY, 1)
    sess = DecodeSession(TINY, params, dtype=torch.float32, device="cpu")
    assert sess.capacity == wavenet_decode.max_streams(TINY, torch.float32)
    small = DecodeSession(TINY, params, capacity=2, device="cpu", steps_per_call=4)
    a = small.add()
    small.add()
    with pytest.raises(RuntimeError, match="session full"):
        small.add()
    assert small.capacity == 2  # never raised
    small.finish(a)
    small.add()
    assert len(small.step()) == 2
    with pytest.raises(ValueError, match="prime must be"):
        small.add(np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="capacity"):
        DecodeSession(TINY, params, capacity=0, device="cpu")
    biased = wn.WaveNetConfig(**{**TINY.__dict__, "use_bias": True})
    with pytest.raises(NotImplementedError, match="use_bias"):
        DecodeSession(biased, _params(biased, 1), device="cpu")
    scan = DecodeSession(biased, _params(biased, 1), backend="scan", device="cpu",
                         steps_per_call=4)
    scan.add()
    assert scan.step()[0].shape == (4,)
    assert DecodeSession(TINY, params, device="cpu").step() == {}
    if not torch.cuda.is_available():
        for make in (lambda: DecodeSession(TINY, params),
                     lambda: AEDecodeSession(AE_TINY, _params(AE_TINY, 0, ae))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


@pytest.mark.parametrize("backend", ["fused", "scan"])
def test_decode_session_state_dict_continues_exactly(backend):
    """A session restored from another's state_dict (categorical: the
    per-call seed is part of the state) continues every stream with the
    same codes as the original."""
    params = _params(TINY, 2)
    kw = dict(capacity=3, dtype=torch.float32, steps_per_call=16, backend=backend,
              device="cpu", seed=11)
    first = DecodeSession(TINY, params, **kw)
    for _ in range(3):
        first.add()
    first.step()
    first.finish(1)
    second = DecodeSession(TINY, params, **kw)
    second.load_state_dict(first.state_dict())
    a, b = first.step(), second.step()
    assert a.keys() == b.keys() == {0, 2}
    for sid in a:
        np.testing.assert_array_equal(a[sid], b[sid])
    assert first.audio(a[0]).dtype == np.float32
    with pytest.raises(ValueError, match="capacity"):
        DecodeSession(TINY, params, **{**kw, "capacity": 1}).load_state_dict(first.state_dict())


def test_ae_session_join_mid_flight_matches_uninterrupted_and_jax():
    """A long source (its encoding wider than a call's frame window) and a
    short one (narrower: padded with its last frame) that joins one call
    later, over three calls: every code passes the tie-aware check on the
    absolute clock, as do the port's uninterrupted decode and JAX's
    ``wavenet_ae.generate_tokens``; with no step near a tie all agree."""
    params = _params(AE_TINY, 3, ae)
    rng = np.random.default_rng(1)
    sources = [rng.integers(0, 32, n).astype(np.int32) for n in (400, 90)]
    sess = AEDecodeSession(AE_TINY, params, capacity=2, steps_per_call=K, device="cpu")
    P = sess._prime_len
    assert sess._Fc < (400 - 1 - sum(AE_TINY.dilations)) // AE_TINY.en_pool_kernel_size
    a = sess.add(sources[0])
    out = {a: [sess.step()[a]]}
    b = sess.add(sources[1])
    out[b] = []
    for _ in range(2):
        for sid, codes in sess.step().items():
            out[sid].append(codes)
    jcfg = jae.WaveNetAEConfig(**{f: getattr(AE_TINY, f)
                                  for f in AE_TINY.__dataclass_fields__})
    jparams = _jax_params(params)
    for sid, chunks in out.items():
        codes = np.concatenate(chunks)
        src = torch.from_numpy(sources[sid])[None]
        with torch.no_grad():
            enc = ae.encode(params, src, AE_TINY)
        whole = aegen._decode(params, enc, src, AE_TINY, len(codes), backend="fused",
                              sample_mode="argmax", seed=0, dtype=torch.float32)[0].numpy()
        jax_codes = np.asarray(jae.generate_tokens(
            jparams, jnp.asarray(enc.numpy()), jnp.asarray(sources[sid][None, :P]),
            jax.random.PRNGKey(0), cfg=jcfg, n_steps=len(codes)))[0]

        def scores(t, enc=enc, src=src):
            return ae_teacher_forced_scores(params, enc, src[:, :P], torch.as_tensor(np.array(t)),
                                            AE_TINY)

        for name, toks in (("session", codes), ("uninterrupted", whole), ("JAX", jax_codes)):
            report = tie_aware_check(toks[None], scores, TOL)
            assert report["ok"], (sid, name, report)
        if _margin(scores(codes[None]), codes) > TOL:
            np.testing.assert_array_equal(whole, codes)
            np.testing.assert_array_equal(jax_codes, codes)
    assert len(np.concatenate(out[a])) == 3 * K and len(np.concatenate(out[b])) == 2 * K


def test_ae_session_admission_and_state_dict():
    params = _params(AE_TINY, 4, ae)
    src = np.random.default_rng(2).integers(0, 32, 300).astype(np.int32)
    sess = AEDecodeSession(AE_TINY, params, steps_per_call=8, device="cpu")
    assert sess.capacity == wavenet_ae_decode.max_streams(AE_TINY, torch.float32)
    small = AEDecodeSession(AE_TINY, params, capacity=1, steps_per_call=8, device="cpu")
    small.add(src)
    with pytest.raises(RuntimeError, match="session full"):
        small.add(src)
    with pytest.raises(ValueError, match="source must be"):
        sess.add(src[:10])
    small.step()
    twin = AEDecodeSession(AE_TINY, params, capacity=1, steps_per_call=8, device="cpu")
    twin.load_state_dict(small.state_dict())
    a, b = small.step(), twin.step()
    np.testing.assert_array_equal(a[0], b[0])
    assert small.audio(a[0]).shape == (8,)
